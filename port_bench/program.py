"""What the harness hands the measured program (sayuri_tpu_torch) and
takes from it: the net built from the configuration with the harness's
weights, the root positions replayed from the harness's move lists, and
the parts of a search tree the reference judges."""

from __future__ import annotations

import dataclasses

import torch

TREE_FIELDS = ("prior", "child", "parent", "stats", "terminal")


def net(cfg_net, weights, device):
    """The program's SayuriNet of the configuration, in eval mode, with
    the harness's weights loaded under its own names (strict)."""
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    names = {f.name for f in dataclasses.fields(NetConfig)}
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg_net.items() if k in names}
    model = SayuriNet(NetConfig(**fields)).to(device).eval()
    model.load_state_dict(weights, strict=True)
    return model


def roots(env, moves, counts, rule, komi, device):
    """GoState of each lane after its moves, played through the program's
    own env from empty boards (`rule` [B] int, `komi` float)."""
    from sayuri_tpu_torch.game.state import GoState

    b = moves.shape[0]
    states = env.new_batch(b, komi=komi, device=device)
    states = states.replace(rule=rule.to(device=device, dtype=torch.int32))
    for t in range(int(counts.max()) if b else 0):
        go = (t < counts).to(device)
        nxt = env.step(states, moves[:, t].clamp(min=0).to(device))
        states = GoState(**{k: torch.where(go.view((-1,) + (1,) * (v.ndim - 1)), v,
                                           getattr(states, k))
                            for k, v in nxt.fields().items()})
    return states


def tree_lanes(tree, lanes):
    """The sampled lanes of a search tree, on the CPU."""
    idx = torch.as_tensor(lanes, device=tree.stats.device)
    out = {k: getattr(tree, k)[idx].cpu() for k in TREE_FIELDS}
    out["stones"] = tree.states.stones[idx].cpu()
    out["ko"] = tree.states.ko[idx].cpu()
    out["next_free"] = tree.next_free[idx].cpu()
    return out
