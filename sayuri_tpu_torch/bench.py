"""Benchmark: NN-evaluated MCTS playouts/s on one CUDA device at 19x19.

Full batched searches with B games in lockstep, from empty boards, as the
JAX package's bench_playouts runs them: the root ladder planes (ladder prep,
greedy and chase kernels) once per search, then the simulations (fused
step+analysis kernel, 43-plane encode, b6c96 forward in bf16 under a random
symmetry, tree update).

    python -m sayuri_tpu_torch.bench [batch] [playouts]

prints ONE JSON line with the rate, the device name and its power limit.

    python -m sayuri_tpu_torch.bench profile [batch] [playouts] [trace.json]

profiles one search: device busy/idle share, host time per search stage,
the top kernels by device time (and a chrome trace when a path is given).

    python -m sayuri_tpu_torch.bench envsteps [batch] [steps]

times the raw env: `batch` 19x19 games (default 4096) stepped `steps`
times (default 64) through ``GoEnv.step_batch_light`` (one light step
kernel launch a step), each move the legal cell of highest integer hash,
chained on the card; prints ONE JSON line, ``env_steps_per_s_19x19``.

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

import torch
from torch.profiler import record_function

METRIC = "mcts_playouts_per_s_19x19_b6c96"
ENV_METRIC = "env_steps_per_s_19x19"
_M32 = 0xFFFFFFFF


def device_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _setup(batch: int, playouts: int, device, seed: int):
    """(MCTS driver, root states): b6c96 with seeded random weights, bf16,
    random symmetry, root ladder planes, `batch` empty 19x19 boards."""
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    env = GoEnv(n=19)
    net = SayuriNet(NetConfig(boardsize=19)).init_random(seed).to(device).eval()
    eval_fn = make_eval_fn(env, net, symmetry="random", ladder_mode="root",
                           compute_dtype=torch.bfloat16)
    mcts = MCTS(env, eval_fn, SearchConfig(max_nodes=playouts + 16, max_depth=64))
    return mcts, env.new_batch(batch, komi=7.5, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _searcher(mcts, states, playouts):
    """One full search: the roots' ladder planes, then init_tree and the
    simulations, all reading them through ctx["ladders"]."""
    from sayuri_tpu_torch.game.ladder import ladder_planes_batch

    def search():
        with record_function("mcts.ladders"):
            ctx = {"ladders": ladder_planes_batch(states.stones, states.size,
                                                  states.ko)}
        return mcts.run(mcts.init_tree(states, ctx), playouts, ctx)

    return search


def bench_playouts(batch: int = 256, playouts: int = 96, device="cuda",
                   iters: int = 3, seed: int = 0, roots=None):
    """Time `iters` searches of `playouts` simulations after one warm-up
    search, from `batch` empty 19x19 boards or, when given, from the 19x19
    GoState `roots` (moved to `device`). Returns a dict with the rate, the
    last tree, the MCTS object and the root states."""
    mcts, states = _setup(batch, playouts, device, seed)
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


def profile_playouts(batch: int = 256, playouts: int = 96, device="cuda",
                     trace: str | None = None, top: int = 12, seed: int = 0):
    """One search after a warm-up one, timed without the profiler, then one
    under torch.profiler. Returns both wall times; the device's busy time
    (union of kernel intervals) and its idle share of the unprofiled wall;
    kernel launches and device ms per `mcts.*` stage (a kernel belongs to
    the stage whose device-side range holds its start); the host ms of each
    stage under the profiler (inflated by the profiler's per-op cost); and
    the `top` kernels by device time."""
    import bisect

    from torch.profiler import ProfilerActivity, profile

    mcts, states = _setup(batch, playouts, device, seed)
    search = _searcher(mcts, states, playouts)

    search()
    _sync(device)
    t0 = time.monotonic()
    search()
    _sync(device)
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        search()
        _sync(device)
        wall_prof = time.monotonic() - t0
    if trace:
        prof.export_chrome_trace(trace)

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the record_function ranges appear on the device timeline as well
    ranges = sorted(
        (e for e in events if e.device_type == cuda and e.name.startswith("mcts.")),
        key=lambda e: e.time_range.start,
    )
    kernels = sorted(
        (e for e in events if e.device_type == cuda
         and not e.name.startswith("mcts.")
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.time_range.start,
    )
    starts = [r.time_range.start for r in ranges]
    busy, end = 0.0, float("-inf")
    per_kernel, per_stage = {}, {}
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        if t > end:
            busy += t - max(s, end)
            end = t
        us = e.time_range.elapsed_us()
        total, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (total + us, count + 1)
        i = bisect.bisect_right(starts, s) - 1
        stage = (ranges[i].name if i >= 0 and s < ranges[i].time_range.end
                 else "outside")
        total, count = per_stage.get(stage, (0.0, 0))
        per_stage[stage] = (total + us, count + 1)
    host = {}
    for e in events:
        if e.device_type != cuda and e.name.startswith("mcts."):
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {
        "wall_ms": wall * 1e3,
        "wall_ms_profiled": wall_prof * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
        "kernel_launches": len(kernels),
        "simulations": playouts,
        "stage_device_ms_launches": {
            k: (us / 1e3, c) for k, (us, c) in sorted(per_stage.items())
        },
        "stage_host_ms_profiled": host,
        "top_kernels_ms": [
            (name, us / 1e3, count) for name, (us, count) in
            sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
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
    if args and args[0] == "profile":
        batch = int(args[1]) if len(args) > 1 else 256
        playouts = int(args[2]) if len(args) > 2 else 96
        res = profile_playouts(batch, playouts,
                               trace=args[3] if len(args) > 3 else None)
        print(json.dumps(dict(res, device=device_info()), indent=1))
        return
    batch = int(args[0]) if args else 256
    playouts = int(args[1]) if len(args) > 1 else 96
    res = bench_playouts(batch, playouts)
    print(json.dumps({
        "metric": METRIC,
        "value": res["rate"],
        "unit": "playouts/s",
        "batch": batch,
        "playouts": playouts,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
