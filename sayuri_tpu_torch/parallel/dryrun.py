"""The multi-rank dry run (port of the JAX package's ``dryrun_multichip``
in ``__graft_entry__.py``): one data-parallel train step of a small 9x9 net,
eight moves of 9x9 self-play over the group, and the collective
invariants.

Each rank calls ``dryrun_multichip(mesh)`` with the same arguments. The JAX
package reads its invariants from the compiled step's HLO; here the caller
wraps ``torch.distributed.all_reduce`` with a function that appends
(elements, ranks of the call's group) to a list, and hands that list in:
the package itself counts nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.parallel import distributed as DI
from sayuri_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from sayuri_tpu_torch.selfplay.actor import SelfplayActor, SelfplayConfig
from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer

# the JAX dry run's net: 9x9, 16 channels, a residual block and an SE one
DRYRUN_NET = NetConfig(boardsize=9, residual_channels=16,
                       stack=("ResidualBlock", "ResidualBlock-SE"), se_ratio=2,
                       policy_head_channels=8, value_head_channels=8)


def dryrun_batch(b: int, n: int = 9, seed: int = 0):
    """The JAX dry run's seeded host batch: planes [b, n, n, 43] (on-board
    mask plane set) and the seven targets."""
    hw = n * n
    rng = np.random.RandomState(seed)
    planes = rng.rand(b, n, n, 43).astype(np.float32)
    planes[..., 42] = 1.0
    prob = rng.rand(b, hw + 1).astype(np.float32)
    prob /= prob.sum(-1, keepdims=True)
    aux = rng.rand(b, hw + 1).astype(np.float32)
    aux /= aux.sum(-1, keepdims=True)
    wdl = np.zeros((b, 3), np.float32)
    wdl[np.arange(b), rng.randint(0, 3, b)] = 1.0
    targets = {
        "prob": prob,
        "aux_prob": aux,
        "ownership": rng.choice([-1.0, 0.0, 1.0], (b, hw)).astype(np.float32),
        "wdl": wdl,
        "q_vals": rng.uniform(-1, 1, (b, 5)).astype(np.float32),
        "scores": rng.uniform(-10, 10, (b, 5)).astype(np.float32),
        "global_weight": np.ones(b, np.float32),
    }
    return planes, targets


def dryrun_multichip(mesh: Mesh, all_reduce_calls: list | None = None,
                     lanes_per_rank: int = 2) -> dict:
    """Run the dry run on this rank and return what it read. With
    `all_reduce_calls` (the list the caller's all-reduce wrapper fills),
    the invariants are asserted on the train step's all-reduces: each spans
    every rank, together they cover at least every parameter. Always
    asserted: each rank's batch is the global batch over the world size,
    the loss is finite, eight moves were played on every rank's lanes."""
    world = mesh.size
    b = world * lanes_per_rank
    trainer = Trainer(DRYRUN_NET, TrainConfig(batch_size=b), mesh=mesh)
    planes, targets = dryrun_batch(b)
    local_planes, local_targets = shard_batch(mesh, planes), shard_batch(mesh, targets)
    assert local_planes.shape == (b // world,) + planes.shape[1:], (
        f"batch not sharded: per-rank {tuple(local_planes.shape)} vs global {planes.shape}")
    if all_reduce_calls is not None:
        all_reduce_calls.clear()
    parts = trainer.train_batch(local_planes, local_targets)
    step_calls = list(all_reduce_calls or [])
    assert np.isfinite(parts["loss"]), parts
    n_params = sum(p.numel() for p in trainer.params)

    # self-play over the group: each rank plays its own lanes of a real net
    env = GoEnv(n=DRYRUN_NET.boardsize)
    net = SayuriNet(DRYRUN_NET).init_random(0).to(mesh.device).eval()
    replicate(mesh, net.state_dict())
    mcts = MCTS(env, make_eval_fn(env, net, symmetry="random"), SearchConfig(max_nodes=24))
    actor = SelfplayActor(env, mcts, SelfplayConfig(playouts=12, fastsearch_playouts=6))
    states = env.new_batch(lanes_per_rank, komi=6.5, device=mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(1 + mesh.rank)
    _, recs = actor.play_games(states, gen, max_moves=8)
    moves = DI.all_gather_to_host([r.move for r in recs])
    assert len(recs) == 8 and all(m.shape == (b,) for m in moves), [m.shape for m in moves]

    if all_reduce_calls is not None:
        assert step_calls, "no all-reduce in the sharded train step"
        assert all(ranks == world for _, ranks in step_calls), step_calls
        elems = sum(n for n, _ in step_calls)
        assert elems >= n_params, (
            f"all-reduced elements {elems} < parameter count {n_params}: the gradient "
            "all-reduce does not cover the full gradient")
    return {"loss": parts["loss"], "parts": parts, "world": world, "local_batch": b // world,
            "n_params": n_params, "all_reduces": len(step_calls),
            "all_reduced_elements": sum(n for n, _ in step_calls),
            "moves": torch.stack(moves).cpu()}
