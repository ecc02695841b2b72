"""Benchmark: NN-evaluated MCTS playouts/s on one CUDA device at 19x19.

Full batched searches (fused step+analysis kernel, 43-plane encode, b6c96
forward in bf16 under a random symmetry, tree update) with B games in
lockstep, from empty boards. Root ladder planes are off until the ladder
kernels are ported, hence the metric name's ``_ladder_off`` suffix.

    python -m sayuri_tpu_torch.bench [batch] [playouts]

prints ONE JSON line with the rate, the device name and its power limit.

    python -m sayuri_tpu_torch.bench profile [batch] [playouts] [trace.json]

profiles one search: device busy/idle share, host time per search stage,
the top kernels by device time (and a chrome trace when a path is given).
A run without a CUDA device fails; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

METRIC = "mcts_playouts_per_s_19x19_b6c96_ladder_off"


def device_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _setup(batch: int, playouts: int, device, seed: int):
    """(MCTS driver, root states): b6c96 with seeded random weights, bf16,
    random symmetry, ladder planes off, `batch` empty 19x19 boards."""
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    env = GoEnv(n=19)
    net = SayuriNet(NetConfig(boardsize=19)).init_random(seed).to(device).eval()
    eval_fn = make_eval_fn(env, net, symmetry="random", ladder_mode="off",
                           compute_dtype=torch.bfloat16)
    mcts = MCTS(env, eval_fn, SearchConfig(max_nodes=playouts + 16, max_depth=64))
    return mcts, env.new_batch(batch, komi=7.5, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_playouts(batch: int = 256, playouts: int = 96, device="cuda",
                   iters: int = 3, seed: int = 0):
    """Time `iters` searches of `playouts` simulations on `batch` empty
    19x19 boards after one warm-up search. Returns a dict with the rate,
    the last tree, the MCTS driver and the root states."""
    mcts, states = _setup(batch, playouts, device, seed)

    def search():
        return mcts.run(mcts.init_tree(states), playouts)

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

    def search():
        return mcts.run(mcts.init_tree(states), playouts)

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


def main():
    if not torch.cuda.is_available():
        sys.exit("bench: no CUDA device; this benchmark runs on the card only")
    args = sys.argv[1:]
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
