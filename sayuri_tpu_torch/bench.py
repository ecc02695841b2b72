"""Benchmark: NN-evaluated MCTS playouts/s on one CUDA device at 19x19.

Full batched searches with B games in lockstep, from empty boards, as the
JAX package's bench_playouts runs them: the root ladder planes (ladder prep,
greedy and chase kernels) once per search, then the simulations (fused
step+analysis kernel, 43-plane encode, b6c96 forward in bf16 under a random
symmetry, tree update).

    python -m sayuri_tpu_torch.bench [batch] [playouts] [--net NET]

prints ONE JSON line with the rate, the device name and its power limit.
``--net`` picks the net of ``bench``, ``bench profile`` and ``bench
train`` from NETS: ``b6c96`` (the default: NetConfig's RL net, residual
blocks) or ``b6c96-mix`` (the same width and depth with one block of each
family, bottleneck, nested bottleneck, mixer V1 and V2 and residual, and
the RepLK policy head) or ``b15c192`` (the benchmark's larger net: 15
residual blocks of 192 channels, SE on every third, 24-channel heads,
mish) or ``b6c96-h24`` (the benchmark's b6c96: 24-channel heads, mish);
the metric's name ends in the net's.

    python -m sayuri_tpu_torch.bench deep [batch]
    python -m sayuri_tpu_torch.bench cached [batch]

the same bench in two variants, as the JAX package's bench.py has them:
``deep``, 400 playouts a search (default batch 128: playouts on bigger
trees cost more each; metric suffix ``_deep400``), and ``cached``, 96
playouts with the NN cache of 1024 sets on (default batch 256; empty-board
lanes transpose heavily, so an upper bound; suffix ``_cached``, with the
last timed search's cache hit rate, hits and in-batch duplicates over the
queries).

    python -m sayuri_tpu_torch.bench profile [batch] [playouts] [trace.json] [--net NET]

profiles one search: device busy/idle share, host time per search stage,
the top kernels by device time, the device ms of the depthwise conv blocks'
convolutions (and a chrome trace when a path is given).

    python -m sayuri_tpu_torch.bench envsteps [batch] [steps]

times the raw env: `batch` 19x19 games (default 4096) stepped `steps`
times (default 64) through ``GoEnv.step_batch_light`` (one light step
kernel launch a step), each move the legal cell of highest integer hash,
chained on the card; prints ONE JSON line, ``env_steps_per_s_19x19``.

    python -m sayuri_tpu_torch.bench selfplay [batch] [moves]

times the self-play actor at 19x19 with the b6c96 net (seeded random
weights, bf16): the search and playout caps of
configs/selfplay-gumbel-p150.txt (150/50 playouts, playout caps at
probability 0.75, Gumbel, NN cache of 512 sets, max_nodes = playouts +
32), tree reuse, `batch` games (default 256) from empty boards for
`moves` moves (default 8) after a one-move warm-up; prints ONE JSON line
with moves/s (lane-moves) and kept positions/s.

    python -m sayuri_tpu_torch.bench gtp [genmoves]

times what a GTP user waits for: the GTP loop as configs/gtp-p400.txt
configures it (19x19, komi 7.5, 400 playouts, tree reuse) with the b6c96
net loaded from a v5 file of seeded random weights (the file
chip_smoke.py loads; bf16), `genmoves` genmove commands (default 8) from
an empty board, alternating colours, after one warm-up genmove on a board
cleared afterwards, then three with tree reuse off; prints ONE JSON line
with the median seconds a genmove (``gtp_genmove_s_19x19_b6c96``), the
B=1 playouts/s and seconds a playout, and the median seconds of a genmove
that searches a new tree (``gtp_fresh_genmove_s_19x19_b6c96``: its
playouts do not depend on how much of the last tree a move kept).

    python -m sayuri_tpu_torch.bench train [--chunks DIR [--codec on|off]] [--net NET]

times the trainer: b6c96 (``NetConfig()``) in the 19x19 buffer, batch 256
(the TrainConfig default), SGD, f32 with TF32 off (the bench sets the two
flags and restores them). Step alone: 5 warm-up and 50 timed steps on one
seeded batch of full 19x19 boards resident on the card; its samples/s is
``train_samples_per_s_19x19_b6c96``. Three more steps under torch.profiler
give the card's busy ms a step (union of kernel intervals), its idle share
of the unprofiled step, launches a step and the top kernels. With
``--chunks``, ``ChunkLoader`` over the chunks under DIR with train_worker's
loader settings (LoopSetting defaults), after 5 warm-up steps, gives three
more readings, beside the board sizes its batches held: the loader alone
(20 batches drained with no step), the 50 steps fed by it (samples/s, the
share of the wall time the step loop waits on it, ms a step inside
train_batch), and 20 more steps with the interpreter's thread switch
interval at 0.5 ms instead of 5 ms. The loader parses each kept sample
with the native chunk codec when it builds; ``--codec on`` requires it,
``--codec off`` parses in Python (``bench_loader`` times the loader alone
either way). Prints ONE JSON line.

    python -m sayuri_tpu_torch.bench kernels-ab OLD_CSRC_DIR

times the board and ladder kernels built from another csrc/ tree (an
earlier commit's, unpacked with ``git archive``) against the package's,
alternately in one process (see ``ab_kernels``); prints a line a case and
one JSON line.

A run without a CUDA device fails; it never falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from sayuri_tpu_torch import telemetry

METRIC = "mcts_playouts_per_s_19x19_b6c96"     # "b6c96" stands for the net's name
ENV_METRIC = "env_steps_per_s_19x19"
SELFPLAY_METRIC = "selfplay_positions_per_s_19x19_b6c96"
GTP_METRIC = "gtp_genmove_s_19x19_b6c96"
GTP_FRESH_METRIC = "gtp_fresh_genmove_s_19x19_b6c96"
TRAIN_METRIC = "train_samples_per_s_19x19_b6c96"
PROFILED_STEPS = 3
LOADER_SIDE_STEPS = 20          # the loader alone, and fed at FAST_SWITCH_S
FAST_SWITCH_S = 0.0005          # a tenth of CPython's default switch interval
_M32 = 0xFFFFFFFF
# the nets --net picks: NetConfig fields over its defaults (19x19, 96
# channels, 32-channel heads, relu); b15c192 and b6c96-h24 as
# port_bench/configs has b15c192 and b6c96
NETS = {
    "b6c96": {},
    "b6c96-mix": dict(stack=("BottleneckBlock", "NestedBottleneckBlock-SE", "MixerBlock",
                             "MixerBlockV2-SE", "ResidualBlock", "ResidualBlock-SE"),
                      policy_head_type="RepLK"),
    "b15c192": dict(residual_channels=192,
                    stack=("ResidualBlock", "ResidualBlock", "ResidualBlock-SE") * 5,
                    policy_head_channels=24, value_head_channels=24, activation="mish"),
    "b6c96-h24": dict(policy_head_channels=24, value_head_channels=24, activation="mish"),
}


def device_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def net_config(net: str = "b6c96", boardsize: int = 19):
    """The NetConfig of a net of NETS."""
    from sayuri_tpu_torch.models.network import NetConfig

    return NetConfig(boardsize=boardsize, **NETS[net])


def _setup(batch: int, playouts: int, device, seed: int, net: str = "b6c96",
           nn_cache_size: int = 0):
    """(MCTS driver, root states): the net (NETS) with seeded random weights,
    bf16, random symmetry, root ladder planes, `batch` empty 19x19 boards;
    the NN cache of `nn_cache_size` sets (0: none)."""
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import SayuriNet

    env = GoEnv(n=19)
    model = SayuriNet(net_config(net)).init_random(seed).to(device).eval()
    eval_fn = make_eval_fn(env, model, symmetry="random", ladder_mode="root",
                           compute_dtype=torch.bfloat16)
    mcts = MCTS(env, eval_fn, SearchConfig(max_nodes=playouts + 16, max_depth=64,
                                           nn_cache_size=nn_cache_size))
    return mcts, env.new_batch(batch, komi=7.5, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _searcher(mcts, states, playouts):
    """One full search: the roots' ladder planes, then init_tree and the
    simulations, all reading them through ctx["ladders"]."""
    from sayuri_tpu_torch.game.ladder import ladder_planes_batch

    def search():
        with telemetry.span("mcts.ladders"):
            ctx = {"ladders": ladder_planes_batch(states.stones, states.size,
                                                  states.ko)}
        return mcts.run(mcts.init_tree(states, ctx=ctx), playouts, ctx=ctx)

    return search


def bench_playouts(batch: int = 256, playouts: int = 96, device="cuda",
                   iters: int = 3, seed: int = 0, roots=None, net: str = "b6c96",
                   nn_cache_size: int = 0):
    """Time `iters` searches of `playouts` simulations of `net` (NETS)
    after one warm-up search, from `batch` empty 19x19 boards or, when
    given, from the 19x19 GoState `roots` (moved to `device`); each search
    starts a new NN cache of `nn_cache_size` sets (0: none). Returns a
    dict with the rate, the last tree, the MCTS object and the root
    states."""
    mcts, states = _setup(batch, playouts, device, seed, net, nn_cache_size)
    if roots is not None:
        states = roots.to(device)
        batch = states.stones.shape[0]
    search = _searcher(mcts, states, playouts)

    search()
    _sync(device)
    t0 = time.monotonic()
    for _ in range(iters):
        tree = search()
    _sync(device)
    dt = time.monotonic() - t0
    return {
        "rate": iters * batch * playouts / dt,
        "seconds": dt,
        "searches": 1 + iters,
        "tree": tree,
        "mcts": mcts,
        "states": states,
    }


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x < 2**32 and a 32-bit constant c, in
    two 16-bit halves of c so that no product leaves int64 (torch has no
    full uint32 arithmetic on CUDA)."""
    lo = (x * (c & 0xFFFF)) & _M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def env_steps_rollout(env, states, steps: int, seed: int):
    """The env-steps loop: a pass pre-step for the first legal mask, then
    `steps` light steps, each lane playing the legal cell with the largest
    integer hash of (lane, step, seed, cell) (pass where none is legal; the
    JAX bench's hash). Returns the final states."""
    n = env.n
    nn = n * n
    b = states.stones.shape[0]
    dev = states.stones.device
    states, legal = env.step_batch_light(
        states, torch.full((b,), nn, dtype=torch.int32, device=dev))
    lane = _mul32(torch.arange(b, device=dev)[:, None], 2654435761)
    cell = _mul32(torch.arange(nn, device=dev)[None, :], 2246822519)
    for i in range(steps):
        h = lane ^ ((i * 0x9E3779B9 + seed) & _M32) ^ cell
        h = h ^ (h >> 15)
        h = _mul32(h, 2654435761)
        h = h ^ (h >> 13)
        acts = torch.where(legal, h, 0).argmax(-1)
        acts = torch.where(legal.any(-1), acts, nn).to(torch.int32)
        states, legal = env.step_batch_light(states, acts)
    return states


def bench_env_steps(batch: int = 4096, steps: int = 64, device="cuda",
                    iters: int = 3):
    """Time `iters` env-steps rollouts (seeds 1..iters) of `batch` empty
    19x19 boards after one warm-up rollout (seed 0). Returns a dict with
    the rate (steps of all lanes per second), the seconds, the number of
    rollouts run and the last final states."""
    from sayuri_tpu_torch.game.state import GoEnv

    env = GoEnv(n=19)
    states = env.new_batch(batch, komi=7.5, device=device)
    env_steps_rollout(env, states, steps, 0)
    _sync(device)
    t0 = time.monotonic()
    for i in range(iters):
        out = env_steps_rollout(env, states, steps, i + 1)
    _sync(device)
    dt = time.monotonic() - t0
    return {"rate": iters * batch * steps / dt, "seconds": dt,
            "rollouts": 1 + iters, "states": out}


SELFPLAY_CONFIG = Path(__file__).resolve().parents[1] / "configs" / "selfplay-gumbel-p150.txt"


def _selfplay_setup(batch: int, device="cuda", seed: int = 0, **over):
    """(actor, root states): the search and playout caps of
    configs/selfplay-gumbel-p150.txt (`over` replaces options of that file,
    e.g. nn_cache_size=0) on the b6c96 net (seeded random weights, bf16 on
    the card), `batch` empty 19x19 boards."""
    from sayuri_tpu_torch.config import Options
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
    from sayuri_tpu_torch.selfplay.actor import SelfplayActor

    opts = Options().parse_args(["--config", str(SELFPLAY_CONFIG)])
    for name, value in over.items():
        opts.set(name, value)
    env = GoEnv(n=19)
    net = SayuriNet(NetConfig(boardsize=19)).init_random(seed).to(device).eval()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    eval_fn = make_eval_fn(env, net, symmetry="random", ladder_mode="root",
                           compute_dtype=dtype)
    actor = SelfplayActor(env, MCTS(env, eval_fn, opts.search_config()),
                          opts.selfplay_config())
    return actor, env.new_batch(batch, komi=7.5, device=device)


GTP_CONFIG = Path(__file__).resolve().parents[1] / "configs" / "gtp-p400.txt"


V5_SEED = 11     # the seed of the v5 file bench gtp and chip_smoke.py load


def write_seeded_v5(path):
    """Write the b6c96 net with random weights seeded by V5_SEED as a v5
    file at `path` (the file `--weights` loads); returns `path`."""
    from sayuri_tpu_torch.models import weights_io as W
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    W.export_reference_weights(SayuriNet(NetConfig(boardsize=9)).init_random(V5_SEED), str(path))
    return path


def bench_gtp(genmoves: int = 8, fresh: int = 3, device="cuda", argv=()):
    """Time the loop that ``--mode gtp --config configs/gtp-p400.txt
    --weights F`` builds (`argv`: more flags), F the seeded b6c96 v5 file
    of `write_seeded_v5`, after one warm-up genmove on a board cleared
    afterwards: `genmoves` genmoves (alternating colours, from an empty
    board) with the config's tree reuse, then `fresh` more with tree reuse
    off, each a search from a new tree. Returns a dict with each genmove's
    seconds and playouts, the median of each run, the moves, the B=1
    playouts/s and seconds a playout of the reuse run."""
    import statistics
    import tempfile

    from sayuri_tpu_torch.__main__ import build_gtp_loop
    from sayuri_tpu_torch.config import Options

    with tempfile.TemporaryDirectory() as tmp:
        wfile = write_seeded_v5(Path(tmp) / f"b6c96-seed{V5_SEED}.txt")
        opts = Options().parse_args(["--config", str(GTP_CONFIG), "--weights", str(wfile),
                                     *argv])
        opts.check_gtp_flags()
        loop = build_gtp_loop(opts, device=device)

    def run(lines):
        seconds, moves, playouts = [], [], []
        for line in lines:
            _sync(device)
            t0 = time.monotonic()
            ok, body = loop.execute(line)
            _sync(device)
            if not ok:
                raise RuntimeError(f"{line}: ? {body}")
            if line.startswith("genmove"):
                seconds.append(time.monotonic() - t0)
                moves.append(body)
                playouts.append(loop.agent.last_stats["playouts"])
        return seconds, moves, playouts

    run(("clear_board", "genmove b", "clear_board"))
    seconds, moves, playouts = run([f"genmove {'bw'[i % 2]}" for i in range(genmoves)])
    fresh_s, fresh_moves, fresh_playouts = run(
        ["sayuri-setoption name reuse tree value false"]
        + [f"genmove {'bw'[(genmoves + i) % 2]}" for i in range(fresh)])
    return {"median_s": statistics.median(seconds), "seconds": seconds, "moves": moves,
            "playouts": playouts, "playouts_per_s": sum(playouts) / sum(seconds),
            "s_per_playout": sum(seconds) / sum(playouts),
            "fresh_median_s": statistics.median(fresh_s),
            "fresh_seconds": fresh_s, "fresh_moves": fresh_moves,
            "fresh_playouts": fresh_playouts, "loop": loop}


def bench_selfplay(batch: int = 256, moves: int = 8, device="cuda", seed: int = 0, **over):
    """Time `moves` self-play moves of `batch` games after a one-move
    warm-up batch (`over`: see `_selfplay_setup`). Returns a dict with
    moves/s (moves of all lanes per second), kept (full-search)
    positions/s, the seconds, the records and the cache counters."""
    actor, states = _selfplay_setup(batch, device, seed, **over)
    gen = torch.Generator(device=device).manual_seed(seed)
    actor.play_games(states, gen, max_moves=1)
    _sync(device)
    t0 = time.monotonic()
    final, records = actor.play_games(states, gen, max_moves=moves)
    _sync(device)
    dt = time.monotonic() - t0
    lane_moves = sum(int(r.active.sum()) for r in records)
    kept = sum(int((r.active & ~r.discard).sum()) for r in records)
    return {"moves_per_s": lane_moves / dt, "positions_per_s": kept / dt,
            "seconds": dt, "moves": len(records), "lane_moves": lane_moves,
            "positions": kept, "records": records, "final": final,
            "queries": actor.last_query_stats,
            "playouts": [actor.cfg.playouts, actor.cfg.fastsearch_playouts],
            "nn_cache_size": actor.mcts.cfg.nn_cache_size}


def train_batch_seeded(batch: int):
    """A seeded numpy training batch of full 19x19 boards in the layout
    ``dataset.wrap_sample`` gives (binary planes, scalar planes, mask;
    normalised policies, ownership, one-hot wdl, q values, scores)."""
    import numpy as np

    rng = np.random.RandomState(0)
    n = 19
    hw = n * n
    planes = (rng.rand(batch, n, n, 43) < 0.3).astype(np.float32)
    planes[..., 37:42] = rng.normal(size=(batch, 1, 1, 5))
    planes[..., 42] = 1.0
    prob = rng.rand(2, batch, hw + 1).astype(np.float32) ** 8
    prob /= prob.sum(-1, keepdims=True)
    wdl = np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)]
    return planes, {
        "prob": prob[0], "aux_prob": prob[1],
        "ownership": rng.choice([-1.0, 1.0], (batch, hw)).astype(np.float32),
        "wdl": wdl,
        "q_vals": rng.uniform(-1, 1, (batch, 5)).astype(np.float32),
        "scores": rng.normal(0, 10, (batch, 5)).astype(np.float32),
        "global_weight": np.ones(batch, np.float32),
    }


def _loader(chunks, batch, codec=None):
    """ChunkLoader over the chunks under `chunks` with train_worker's
    settings (LoopSetting defaults) in the 19x19 buffer; (loader, files)."""
    from sayuri_tpu_torch.train import dataset as DS
    from sayuri_tpu_torch.train.setting import LoopSetting

    loop = LoopSetting()
    files, _ = DS.select_window_chunks(str(chunks))
    return DS.ChunkLoader(files, nn_size=19, batch_size=batch,
                          down_sample_rate=loop.down_sample_rate,
                          policy_surprise_factor=loop.policy_surprise_factor,
                          shuffle_capacity=max(256, loop.buffer_size // 64),
                          virtual_buffsize=64, seed=0, codec=codec), files


def bench_loader(chunks, codec=None, batch: int = 256, batches: int = LOADER_SIDE_STEPS):
    """The loader alone over the chunks under `chunks` (train_worker's
    settings, 19x19 buffer): `batches` batches drained after one, with the
    native codec (`codec` True), the Python parse (False) or whichever
    builds (None). Returns samples/s, the board sizes of the batches, and
    the samples each parse took."""
    import numpy as np

    loader, files = _loader(chunks, batch, codec)
    try:
        it = iter(loader)
        next(it)
        t0 = time.monotonic()
        drained = [next(it) for _ in range(batches)]
        dt = time.monotonic() - t0
    finally:
        loader.close()
    cells = np.concatenate([p[..., -1].sum((1, 2)) for p, _ in drained])
    return {"samples_per_s": batch * batches / dt, "seconds": dt, "batches": batches,
            "codec": loader.codec, "native_parses": loader.native_parses,
            "python_parses": loader.python_parses, "chunks": len(files),
            "boards": sorted({int(round(float(c) ** 0.5)) for c in cells})}


def bench_train(chunks=None, device="cuda", batch: int = 256, warmup: int = 5,
                steps: int = 50, net: str = "b6c96", codec=None):
    """Time the trainer of `net` (NETS) at 19x19 (SGD, f32, TF32 off): `steps` steps
    on one device-resident batch after `warmup`, then, when `chunks` (a
    directory) is given, ChunkLoader with train_worker's settings after
    `warmup` steps: the loader alone, `steps` steps fed by it, and steps
    fed by it at a short thread switch interval. `codec`: the loader's
    (None: the native codec when it builds). Returns a dict."""
    import numpy as np

    from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        trainer = Trainer(net_config(net), TrainConfig(batch_size=batch), seed=0,
                          device=device)
        planes, targets = train_batch_seeded(batch)
        planes = torch.as_tensor(planes, device=device)
        targets = {k: torch.as_tensor(v, device=device) for k, v in targets.items()}
        for _ in range(warmup):
            trainer.train_batch(planes, targets)
        _sync(device)
        t0 = time.monotonic()
        for _ in range(steps):
            parts = trainer.train_batch(planes, targets)
        _sync(device)
        dt = time.monotonic() - t0
        res = {"step_ms": 1e3 * dt / steps, "step_samples_per_s": batch * steps / dt,
               "loss": parts["loss"], "batch": batch, "steps": steps}
        if torch.device(device).type == "cuda":
            # a short window under the profiler: the device's busy time a step
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_STEPS):
                    trainer.train_batch(planes, targets)
                _sync(device)
            kernels, busy = _device_kernels(prof.events())
            per = {}
            for e in kernels:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            res.update(device_busy_ms=busy / 1e3 / PROFILED_STEPS,
                       device_idle_share=1.0 - busy / 1e3 / PROFILED_STEPS / res["step_ms"],
                       launches_a_step=len(kernels) / PROFILED_STEPS,
                       top_kernels_ms=sorted(((n, t / PROFILED_STEPS) for n, t in per.items()),
                                             key=lambda kv: -kv[1])[:6])
        if chunks is None:
            return res
        loader, files = _loader(chunks, batch, codec)
        res["codec"] = loader.codec
        side = min(steps, LOADER_SIDE_STEPS)
        switch = sys.getswitchinterval()
        try:
            it = iter(loader)
            for _ in range(warmup):
                trainer.train_batch(*next(it))
            _sync(device)
            t0 = time.monotonic()
            drained = [next(it) for _ in range(side)]
            res["loader_alone_samples_per_s"] = batch * side / (time.monotonic() - t0)
            cells = np.concatenate([p[..., -1].sum((1, 2)) for p, _ in drained])
            res["chunk_boards"] = sorted({int(round(float(c) ** 0.5)) for c in cells})
            del drained
            for key, n, interval in (("loader", steps, switch),
                                     ("loader_fast_switch", side, FAST_SWITCH_S)):
                sys.setswitchinterval(interval)
                wait = 0.0
                t0 = time.monotonic()
                for _ in range(n):
                    t1 = time.monotonic()
                    batch_np = next(it)
                    wait += time.monotonic() - t1
                    trainer.train_batch(*batch_np)
                _sync(device)
                dt = time.monotonic() - t0
                res.update({f"{key}_samples_per_s": batch * n / dt,
                            f"{key}_wait_share": wait / dt,
                            f"{key}_step_ms": 1e3 * dt / n,
                            f"{key}_train_ms": 1e3 * (dt - wait) / n})
        finally:
            sys.setswitchinterval(switch)
            loader.close()
        return dict(res, chunks=len(files))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _device_kernels(events, skip=None):
    """The profiler's device kernels sorted by start (user ranges, and names
    starting with `skip`, left out) and their busy time in us: the union
    of their intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(
        (e for e in events if e.device_type == cuda
         and not (skip and e.name.startswith(skip))
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.time_range.start,
    )
    busy, end = 0.0, float("-inf")
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy += t - max(s, end)
            end = t
    return kernels, busy


DW_RANGE = "net.depthwise_conv"


def profile_playouts(batch: int = 256, playouts: int = 96, device="cuda",
                     trace: str | None = None, top: int = 12, seed: int = 0,
                     net: str = "b6c96"):
    """One search of `net` (NETS) after a warm-up one, timed without the
    profiler, then one under torch.profiler. Returns both wall times; the
    device's busy time (union of kernel intervals) and its idle share of the
    unprofiled wall; kernel launches and device ms per `mcts.*` stage (a
    kernel belongs to the stage whose device-side range holds its start);
    the recorder's host ms of each span of the unprofiled search (the
    `mcts.*` stages, `mcts.descent.sync`, the `evaluate.*` sub-stages) and
    its descent syncs a simulation; the `top` kernels by device time; and, by
    kernel name, the device ms and launches of the depthwise conv blocks'
    convolutions (their merged kernel and the grouped conv, in a
    DW_RANGE range during the profiled search only)."""
    import bisect

    from torch.profiler import ProfilerActivity, profile

    from sayuri_tpu_torch.models.network import DepthwiseConvBlock

    mcts, states = _setup(batch, playouts, device, seed, net)
    search = _searcher(mcts, states, playouts)

    search()
    _sync(device)
    t0 = time.monotonic()
    search()
    _sync(device)
    wall = time.monotonic() - t0
    rec = telemetry.last(profiled=False)
    conv2d = DepthwiseConvBlock.conv2d

    def ranged(self, *args):
        with telemetry.span(DW_RANGE):
            return conv2d(self, *args)

    DepthwiseConvBlock.conv2d = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            search()
            _sync(device)
            wall_prof = time.monotonic() - t0
    finally:
        DepthwiseConvBlock.conv2d = conv2d
    if trace:
        prof.export_chrome_trace(trace)

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the spans' profiler ranges appear on the device timeline as well

    def device_ranges(name):
        return sorted((e for e in events if e.device_type == cuda and e.name.startswith(name)),
                      key=lambda e: e.time_range.start)

    # the descent's sync span nests in `mcts.descent`: a stage is the one
    # range holding a kernel's start, so the stages leave it out
    ranges = [r for r in device_ranges("mcts.") if r.name != "mcts.descent.sync"]
    dw_ranges = device_ranges(DW_RANGE)
    kernels, busy = _device_kernels(events, skip=("mcts.", DW_RANGE))
    starts = [r.time_range.start for r in ranges]
    dw_starts = [r.time_range.start for r in dw_ranges]
    per_kernel, per_stage, per_dw = {}, {}, {}
    for e in kernels:
        s = e.time_range.start
        us = e.time_range.elapsed_us()
        total, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (total + us, count + 1)
        i = bisect.bisect_right(starts, s) - 1
        stage = (ranges[i].name if i >= 0 and s < ranges[i].time_range.end
                 else "outside")
        total, count = per_stage.get(stage, (0.0, 0))
        per_stage[stage] = (total + us, count + 1)
        i = bisect.bisect_right(dw_starts, s) - 1
        if i >= 0 and s < dw_ranges[i].time_range.end:
            total, count = per_dw.get(e.name, (0.0, 0))
            per_dw[e.name] = (total + us, count + 1)
    dw_ms = sum(us for us, _ in per_dw.values()) / 1e3
    return {
        "net": net,
        "wall_ms": wall * 1e3,
        "wall_ms_profiled": wall_prof * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
        "kernel_launches": len(kernels),
        "simulations": playouts,
        "stage_device_ms_launches": {
            k: (us / 1e3, c) for k, (us, c) in sorted(per_stage.items())
        },
        "stage_host_ms": {k: rec.ms(k) for k in sorted(rec.ns)},
        "descent_syncs_per_sim": rec.counter("descent_syncs") / rec.sims,
        "top_kernels_ms": [
            (name, us / 1e3, count) for name, (us, count) in
            sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
        ],
        "depthwise_device_ms": dw_ms,
        "depthwise_busy_share": dw_ms / (busy / 1e3) if busy else 0.0,
        "depthwise_wall_share": dw_ms / (wall * 1e3),
        "depthwise_kernels_ms": [
            (name, us / 1e3, count) for name, (us, count) in
            sorted(per_dw.items(), key=lambda kv: -kv[1][0])
        ],
    }


AB_ROUNDS, AB_INNER = 25, 10


def ab_kernels(old_csrc, device="cuda"):
    """Times the board and ladder kernels built from another source tree
    (`old_csrc`: its analysis.cu, flood.cu, ladder.cu and headers, e.g. an
    earlier commit's csrc/) against the package's, in one process on one
    card. The old libraries are built into a temporary directory. Both
    sides run through the package's own wrappers, their library (``_lib``
    of ops/analysis.py, ops/flood.py and ops/ladder_kernel.py) pointed at
    that side's build. Inputs: the 256 random 19x19 positions of
    chip_smoke.py phase 3 and the stress boards of game/positions.py, at the
    main paths' board counts (a kernel whose source is the same on both
    sides reads the spread of two equal builds); the ladder searches on
    the lanes that ladder_planes_batch gives them on those positions
    (greedy: every lane, chase: the forked ones). AB_INNER calls of a case
    are captured in one CUDA graph a side; each of AB_ROUNDS rounds replays
    both graphs in alternating order, with CUDA events around each replay.
    Returns per case the median ms a call of each side, every round's
    reading, and whether the two sides' outputs are equal."""
    import contextlib
    import statistics
    import tempfile
    from pathlib import Path

    from sayuri_tpu_torch.game import board as TB
    from sayuri_tpu_torch.game import ladder as TL
    from sayuri_tpu_torch.game.positions import random_positions, stress_positions
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import build
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK

    dev = torch.device(device)
    tmp = Path(tempfile.mkdtemp(prefix="sayuri_ab_"))
    mods = (TA, FK, LK)
    libs = {"new": tuple(m._lib() for m in mods)}
    old = []
    for name, mod in zip(("analysis", "flood", "ladder"), mods):
        build.compile_library(Path(old_csrc) / f"{name}.cu", tmp / f"lib{name}.so")
        old.append(mod.bind(ctypes.CDLL(str(tmp / f"lib{name}.so"))))
    libs["old"] = tuple(old)

    @contextlib.contextmanager
    def side(k):
        saved = tuple(m._lib for m in mods)
        for m, lib in zip(mods, libs[k]):
            m._lib = lambda lib=lib: lib
        try:
            yield
        finally:
            for m, fn in zip(mods, saved):
                m._lib = fn

    def tiled(ts, boards):
        return tuple(t.repeat((-(-boards // t.shape[0]),) + (1,) * (t.ndim - 1))
                     [:boards].to(dev).contiguous() for t in ts)

    def flat(out):
        if isinstance(out, dict):
            return list(out.values())
        return list(out) if isinstance(out, tuple) else [out]

    s, a = random_positions(19, 256, seed=0, max_moves=260)
    rnd = (s.stones, s.size, s.ko, s.to_move, a)
    stress = stress_positions(19)[:5]
    black, white = s.stones == 1, s.stones == 2
    colours = torch.cat([black, white])                      # both colours: 512
    st_masks = torch.cat([stress[0] == c for c in (0, 1, 2)])
    # seeded at the cells next to an empty one, as reach() seeds: on the
    # double spiral the black flood starts at the one hole and climbs
    # every turn of the snake
    st_libs = st_masks & TB.nbr_or((stress[0] == 0).repeat(3, 1, 1))

    def flood_args(masks, boards):
        (m,) = tiled((masks,), boards)
        return m & TB.nbr_or(~m), m

    n = s.stones.shape[-1]
    lanes, ok = TL.chase_lanes(*(t.to(dev) for t in (s.stones, s.size, s.ko)))[2:]
    ok = ok.to(torch.int32)
    forked = LK.run_greedy(*lanes, ok, n)[1]
    greedy_lanes = (*lanes, ok)
    forked_lanes = (*lanes, ((forked > 0) & (ok > 0)).to(torch.int32))

    cases = {
        "step_and_analyze B=256": (TA.step_and_analyze, tiled(rnd, 256)),
        "step_and_analyze B=256 stress": (TA.step_and_analyze, tiled(stress, 256)),
        "board_analysis B=256": (TA.board_analysis, tiled(rnd[:4], 256)),
        "ladder_prep B=256": (TA.ladder_prep, tiled(rnd[:3], 256)),
        "ladder_prep B=256 stress": (TA.ladder_prep, tiled(stress[:3], 256)),
        "step_and_legal B=256": (TA.step_and_legal, tiled(rnd, 256)),
        "step_and_legal B=4096": (TA.step_and_legal, tiled(rnd, 4096)),
        "chain_labels 256 boards": (FK.chain_labels, tiled((black,), 256)),
        "chain_labels 512 boards": (FK.chain_labels, tiled((colours,), 512)),
        "chain_labels 512 boards stress": (FK.chain_labels, tiled((st_masks,), 512)),
        "chain_labels 92416 boards": (FK.chain_labels, tiled((colours,), 92416)),
        "flood 256 boards": (FK.flood, flood_args(black, 256)),
        "flood 512 boards": (FK.flood, flood_args(colours, 512)),
        "flood 92416 boards": (FK.flood, flood_args(colours, 92416)),
        "flood 512 boards stress": (FK.flood, tiled((st_libs, st_masks), 512)),
        f"run_greedy {lanes[0].shape[0]} lanes": (
            lambda *a: LK.run_greedy(*a, n), greedy_lanes),
        f"run_chases {int(forked_lanes[6].sum())} forked lanes": (
            lambda *a: LK.run_chases(*a, n), forked_lanes),
    }
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def replay(graph):
        ev[0].record()
        graph.replay()
        ev[1].record()
        torch.cuda.synchronize(dev)
        return ev[0].elapsed_time(ev[1]) / AB_INNER

    report = {}
    for name, (fn, args) in cases.items():
        outs, graphs = {}, {}
        for k in libs:
            with side(k):
                for _ in range(2):
                    outs[k] = flat(fn(*args))
                torch.cuda.synchronize(dev)
                graphs[k] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[k]):
                    for _ in range(AB_INNER):
                        fn(*args)
        torch.cuda.synchronize(dev)
        equal = all(torch.equal(x, y) for x, y in zip(outs["old"], outs["new"]))
        ms = {k: [] for k in libs}
        for r in range(AB_ROUNDS):
            for k in (("old", "new") if r % 2 == 0 else ("new", "old")):
                ms[k].append(replay(graphs[k]))
        report[name] = {**{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
                        "outputs_equal": equal, "rounds_ms": ms}
    return report


def main():
    if not torch.cuda.is_available():
        sys.exit("bench: no CUDA device; this benchmark runs on the card only")
    args = sys.argv[1:]
    net = "b6c96"
    if "--net" in args and args[0] in ("kernels-ab", "envsteps", "selfplay", "gtp", "deep",
                                       "cached"):
        sys.exit(f"bench {args[0]}: --net is read by bench, bench profile and bench train only")
    if "--net" in args:
        i = args.index("--net")
        net = args[i + 1] if i + 1 < len(args) else None
        if net not in NETS:
            sys.exit(f"bench: --net takes one of {sorted(NETS)}")
        del args[i:i + 2]
    if args and args[0] == "kernels-ab":
        res = ab_kernels(args[1])
        for name, r in res.items():
            print(f"{name}: old {r['old_ms']:.4f} ms, new {r['new_ms']:.4f} ms "
                  f"(medians of {AB_ROUNDS}); outputs equal {r['outputs_equal']}")
        print(json.dumps({"kernels_ab": res, "device": device_info()}))
        return
    if args and args[0] == "envsteps":
        batch = int(args[1]) if len(args) > 1 else 4096
        steps = int(args[2]) if len(args) > 2 else 64
        res = bench_env_steps(batch, steps)
        print(json.dumps({
            "metric": ENV_METRIC,
            "value": res["rate"],
            "unit": "steps/s",
            "batch": batch,
            "steps": steps,
            "device": device_info(),
        }))
        return
    if args and args[0] == "selfplay":
        batch = int(args[1]) if len(args) > 1 else 256
        moves = int(args[2]) if len(args) > 2 else 8
        res = bench_selfplay(batch, moves)
        print(json.dumps({
            "metric": SELFPLAY_METRIC,
            "value": res["positions_per_s"],
            "unit": "positions/s",
            "moves_per_s": res["moves_per_s"],
            "batch": batch,
            "moves": moves,
            "playouts": res["playouts"],
            "nn_cache_size": res["nn_cache_size"],
            "queries": res["queries"],
            "device": device_info(),
        }))
        return
    if args and args[0] == "gtp":
        res = bench_gtp(int(args[1]) if len(args) > 1 else 8)
        print(json.dumps({
            "metric": GTP_METRIC,
            "value": res["median_s"],
            "unit": "s/genmove",
            "seconds": res["seconds"],
            "moves": res["moves"],
            "playouts": res["playouts"],
            "playouts_per_s": res["playouts_per_s"],
            "s_per_playout": res["s_per_playout"],
            GTP_FRESH_METRIC: res["fresh_median_s"],
            "fresh_seconds": res["fresh_seconds"],
            "fresh_moves": res["fresh_moves"],
            "fresh_playouts": res["fresh_playouts"],
            "device": device_info(),
        }))
        return
    if args and args[0] == "train":
        codec = None
        if "--codec" in args:
            i = args.index("--codec")
            if args[i + 1:i + 2] not in (["on"], ["off"]):
                sys.exit("bench train: --codec takes on or off")
            codec = args[i + 1] == "on"
            del args[i:i + 2]
        chunks = args[2] if args[1:2] == ["--chunks"] else None
        res = bench_train(chunks=chunks, net=net, codec=codec)
        print(json.dumps({
            "metric": TRAIN_METRIC.replace("b6c96", net),
            "value": res["step_samples_per_s"],
            "unit": "samples/s",
            **res,
            "device": device_info(),
        }))
        return
    if args and args[0] in ("deep", "cached"):
        deep = args[0] == "deep"
        batch = int(args[1]) if len(args) > 1 else (128 if deep else 256)
        playouts, cache_sets = (400, 0) if deep else (96, 1024)
        res = bench_playouts(batch, playouts, nn_cache_size=cache_sets)
        line = {
            "metric": METRIC + ("_deep400" if deep else "_cached"),
            "value": res["rate"],
            "unit": "playouts/s",
            "batch": batch,
            "playouts": playouts,
            "nn_cache_size": cache_sets,
        }
        if cache_sets:
            c = res["tree"].cache
            q, h, d = (int(x.sum()) for x in (c.queries, c.hits, c.dups))
            line.update(cache_hit_rate=(h + d) / max(q, 1), queries=q, hits=h, dups=d)
        print(json.dumps(dict(line, device=device_info())))
        return
    if args and args[0] == "profile":
        batch = int(args[1]) if len(args) > 1 else 256
        playouts = int(args[2]) if len(args) > 2 else 96
        res = profile_playouts(batch, playouts,
                               trace=args[3] if len(args) > 3 else None, net=net)
        print(json.dumps(dict(res, device=device_info()), indent=1))
        return
    batch = int(args[0]) if args else 256
    playouts = int(args[1]) if len(args) > 1 else 96
    res = bench_playouts(batch, playouts, net=net)
    print(json.dumps({
        "metric": METRIC.replace("b6c96", net),
        "value": res["rate"],
        "unit": "playouts/s",
        "batch": batch,
        "playouts": playouts,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
