"""Network evaluator: GoState batch -> NetEvals for the search (PyTorch
port of sayuri_tpu.models.evaluator).

Encoder + forward + output post-processing: policy softmax over legal
moves, value = (wdl_win - wdl_loss + 1) / 2, score = scores[0], all turned
to black's perspective. With symmetry "random" every query is evaluated
under its own dihedral transform drawn from the position hash, and the
spatial outputs are transformed back; "average" evaluates all eight. The
options the GTP engine sets are the policy temperature, the policy head
(the optimistic one for non-root nodes), the pass-suppression factor and
the side-to-move winrate head. With `gammas`, the pattern-gammas policy
is mixed into the priors (``pattern/gammas_device.py``) before the pass
suppression, as the JAX package orders them.

The board analysis the encoder needs (liberties, safe area, score
ownership, legality) comes from ``ctx["analysis"]`` when the fused
step+analysis kernel already produced it, else from one ``board_analysis``
kernel launch (its plain twin for CPU tensors). The ladder planes come from
the root (``ctx["ladders"]``) or, with ``ladder_mode="full"``, from the
ladder kernels on every evaluated position.

``make_dummy_eval_fn`` is the weightless evaluator (random legal priors,
even value) that the GTP engine runs without a net, alone or under
``mcts/rollout.py``'s rollout ownership.
"""

from __future__ import annotations

import torch

from sayuri_tpu_torch.game.ladder import ladder_planes_batch
from sayuri_tpu_torch.game.state import GoEnv, GoState
from sayuri_tpu_torch.mcts.core import NetEvals
from sayuri_tpu_torch.models import symmetry as S
from sayuri_tpu_torch.models.encoder import encode
from sayuri_tpu_torch.models.network import SayuriNet
from sayuri_tpu_torch.ops import analysis as TA


# pass leaves the priors while more than (1 - factor) * size^2 legal board
# moves remain (the reference's default factor)
SUPPRESS_PASS_FACTOR = 0.1667


def suppress_pass(priors, legal, size, factor=SUPPRESS_PASS_FACTOR):
    """Zero the pass prior while more than (1 - factor) * size^2 legal
    board moves remain, then renormalize."""
    n_legal = legal[:, :-1].sum(-1).to(torch.float32)
    thresh = (1.0 - factor) * (size * size).to(torch.float32)
    keep_pass = ~(n_legal > thresh)
    pri = torch.cat([priors[:, :-1], priors[:, -1:] * keep_pass[:, None]], -1)
    return pri / pri.sum(-1, keepdim=True).clamp(min=1e-12)


def make_eval_fn(
    env: GoEnv,
    net: SayuriNet,
    symmetry: int | str = 0,
    ladder_mode: str = "root",
    compute_dtype: torch.dtype = torch.float32,
    policy_temp: float = 1.0,
    sym_seed: int = 0,
    policy_head: str = "prob",
    suppress_pass_factor: float = SUPPRESS_PASS_FACTOR,
    use_stm_winrate: bool = False,
    gammas=None,
):
    """Build eval_fn(states, ctx) -> NetEvals.

    `symmetry`: an int in [0, 8) (fixed transform, 0 = identity),
    "random" (per-query transform from the position hash and `sym_seed`;
    `ctx["sym"]` overrides the draw) or "average" (all eight transforms,
    the activated outputs averaged and the priors renormalized over the
    legal moves).
    `ladder_mode`: "full" computes the ladder planes of every evaluated
    position; "root" reads the root position's planes from
    `ctx["ladders"]` ([B, n, n, 4]) and uses zeros when absent; "off" uses
    zero planes.
    `compute_dtype`: torch.bfloat16 runs the forward under autocast.
    `policy_temp`: the policy logits are divided by it before the softmax.
    `policy_head`: the policy output that feeds the priors ("prob", or
    "optimistic_prob" for the optimistic-policy leaves).
    `suppress_pass_factor`: pass leaves the priors while more than
    (1 - factor) * size^2 legal board moves remain; 0 turns it off.
    `use_stm_winrate`: the value from the net's side-to-move winrate head,
    (q_vals[:, 0] + 1) / 2, instead of (wdl_win - wdl_loss + 1) / 2.
    `gammas`: (DeviceGammas, factor) mixes the pattern-gammas policy into
    the priors of every evaluation, reading the analysis' liberty map.
    `net` must be in eval() mode: in train() mode its batch norm would
    normalise over each query batch and rewrite the running statistics."""
    if net.training:
        raise ValueError("make_eval_fn needs the net in eval() mode")
    if ladder_mode not in ("full", "root", "off"):
        raise ValueError(f"ladder_mode {ladder_mode!r}: use 'full', 'root' or 'off'")
    if not (symmetry in ("random", "average")
            or (isinstance(symmetry, int) and 0 <= symmetry < 8)):
        raise ValueError(f"symmetry {symmetry!r}: use an int in [0, 8), 'random' or "
                         "'average'")
    if policy_head not in ("prob", "optimistic_prob"):
        raise ValueError(f"policy_head {policy_head!r}: use 'prob' or 'optimistic_prob'")
    n = env.n

    @torch.no_grad()
    def eval_fn(states: GoState, ctx=None) -> NetEvals:
        b = states.stones.shape[0]
        dev = states.stones.device
        if ladder_mode == "full":
            lp = ladder_planes_batch(states.stones, states.size, states.ko)
        elif ladder_mode == "root" and ctx is not None and "ladders" in ctx:
            lp = ctx["ladders"]
        else:
            lp = torch.zeros((b, n, n, 4), device=dev)

        if ctx is not None and "analysis" in ctx:
            analysis = ctx["analysis"]
        else:
            analysis = TA.board_analysis(states.stones, states.size, states.ko,
                                      states.to_move)
        planes = encode(env, states, lp, analysis["libs"], analysis["safe"],
                        analysis["score_ownership"])
        board_legal = analysis["legal"] & ~states.terminated[:, None]
        legal = torch.cat([board_legal, torch.ones_like(board_legal[:, :1])], -1)
        is_black = states.to_move == 0

        def forward(x):
            with torch.autocast(dev.type, dtype=compute_dtype,
                                enabled=compute_dtype != torch.float32):
                return net(x)

        def postprocess(out, inverse):
            """Net outputs -> NetEvals in black's view; `inverse` maps a
            [B, A] or [B, HW] spatial output back to the board frame."""
            logits = torch.where(legal, inverse(out[policy_head].float()) / policy_temp,
                                 -torch.inf)
            priors = torch.where(legal, torch.softmax(logits, -1), 0.0)
            wdl = torch.softmax(out["wdl"].float(), -1)
            if use_stm_winrate:
                stm_wl = (out["q_vals"][:, 0].float() + 1.0) / 2.0
            else:
                stm_wl = (wdl[:, 0] - wdl[:, 2] + 1.0) / 2.0
            stm_score = out["scores"][:, 0].float()
            return NetEvals(
                priors=priors,
                black_wl=torch.where(is_black, stm_wl, 1.0 - stm_wl),
                draw=wdl[:, 1],
                black_score=torch.where(is_black, stm_score, -stm_score),
                black_ownership=(inverse(out["ownership"].float())
                                 * torch.where(is_black, 1.0, -1.0)[:, None]),
            )

        if symmetry == "average":
            acc = None
            for s in range(8):
                ev = postprocess(forward(S.transform_planes(planes, s)),
                                 lambda p, s=s: S.inverse_transform_policy(p, s, n))
                acc = ev if acc is None else NetEvals(*(a + e for a, e in zip(acc, ev)))
            acc = NetEvals(*(a / 8.0 for a in acc))
            pri = torch.where(legal, acc.priors, 0.0)
            evals = acc._replace(priors=pri / pri.sum(-1, keepdim=True).clamp(min=1e-12))
        elif symmetry == "random":
            if ctx is not None and "sym" in ctx:
                syms = ctx["sym"]
            else:
                syms = S.random_symmetries(states, sym_seed)
            evals = postprocess(forward(S.transform_planes_batch(planes, syms)),
                                lambda p: S.inverse_transform_policy_batch(p, syms, n))
        elif symmetry:
            evals = postprocess(forward(S.transform_planes(planes, symmetry)),
                                lambda p: S.inverse_transform_policy(p, symmetry, n))
        else:
            evals = postprocess(forward(planes), lambda p: p)
        if gammas is not None:
            from sayuri_tpu_torch.pattern import gammas_device as GD

            evals = GD.apply_to_evals(gammas[0], gammas[1], states, evals, legal,
                                      libs=analysis["libs"])
        if suppress_pass_factor > 0.0:
            evals = evals._replace(priors=suppress_pass(evals.priors, legal, states.size,
                                                        suppress_pass_factor))
        return evals

    return eval_fn


_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer finalizer (xor-shift-multiply) on int64 tensors holding
    values < 2**32; every product stays below 2**59."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def hash_uniform(words, num: int):
    """[B, num] float32 in [0, 1), a deterministic function of the [B, 2]
    hash words (values < 2**32) and the column index."""
    col = torch.arange(num, device=words.device, dtype=torch.int64)
    x = _mix32(words[:, :1] ^ ((col * 0x9E3779B9) & _M32))
    x = _mix32(x ^ words[:, 1:2])
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def make_dummy_eval_fn(env: GoEnv, rng_seed: int = 0, suppress_pass_factor: float = 0.0):
    """Random-output evaluator for weightless runs: priors 0.5 + noise on
    the legal actions, normalized, then pass suppressed as make_eval_fn
    does when `suppress_pass_factor` > 0; value 0.5, no draw, score and
    ownership 0. The noise is a deterministic function of the position
    hash, so a search stays reproducible; `rng_seed` is ignored, as in
    the JAX package (kept for its signature). The JAX package draws the
    noise from threefry keyed by the hash, the port takes an integer hash
    of the hash words and the action (the two give different numbers)."""
    del rng_seed

    def eval_fn(states: GoState, ctx=None) -> NetEvals:
        b = states.stones.shape[0]
        dev = states.stones.device
        legal = env.legal_action_mask(states)
        noise = hash_uniform(states.hash, env.num_actions)
        priors = torch.where(legal, 0.5 + noise, 0.0)
        priors = priors / priors.sum(-1, keepdim=True).clamp(min=1e-9)
        if suppress_pass_factor > 0.0:
            priors = suppress_pass(priors, legal, states.size, suppress_pass_factor)
        zeros = torch.zeros((b,), device=dev)
        return NetEvals(
            priors=priors,
            black_wl=torch.full((b,), 0.5, device=dev),
            draw=zeros,
            black_score=zeros,
            black_ownership=torch.zeros((b, env.n * env.n), device=dev),
        )

    return eval_fn
