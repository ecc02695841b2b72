#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sayuri_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit; TF32 off for the f32 phases.
2. build: compile csrc/analysis.cu with nvcc for sm_90a (first use).
3. kernel parity: random legal 19x19 positions (B=256, numpy seed) plus
   the pass-dead golden boards, through both CUDA kernels and their plain
   twins on the CPU: every output equal cell for cell; kernel and plain
   version timed on the card at B=256.
4. slice: bench_playouts(256, 96) (19x19, b6c96, bf16, random symmetry,
   ladder planes off), one warm-up search and three timed; launch counters
   prove the main path ran through both kernels.
5. f32 search parity: 9x9, B=8, 32 playouts, the same seeded weights on the
   card and on the CPU (twins): root NetEvals within 1e-4, share of lanes
   with identical root visit vectors reported.

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}. There is no CPU fallback: without a CUDA
device the script fails.
"""

import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARITY_B = 256
SLICE_BATCH, SLICE_PLAYOUTS = 256, 96
EVAL_ATOL = 1e-4  # f32 card vs CPU: conv/matmul sums in another order


def phase(name):
    print(f"== {name}", flush=True)


def random_positions(torch, np, n, b, seed, max_moves):
    """Legal random games with the port's plain env on the CPU; each lane
    stops after its own number of moves. Returns (states, actions) with
    one legal next action per lane (some passes)."""
    from sayuri_tpu_torch.game.state import GoEnv

    env = GoEnv(n=n)
    rng = np.random.RandomState(seed)
    s = env.new_batch(b)
    stop = rng.randint(0, max_moves, size=b)
    for m in range(max_moves):
        legal = env.legal_action_mask(s).numpy()
        acts = np.array([
            rng.choice(np.nonzero(l[:-1])[0])
            if l[:-1].any() and m < stop[i] else n * n
            for i, l in enumerate(legal)
        ], np.int32)
        s = env.step(s, torch.from_numpy(acts))
        # keep lanes alive: passes here only mark a lane as finished
        s = s.replace(terminated=torch.zeros_like(s.terminated),
                      pass_count=torch.zeros_like(s.pass_count))
    legal = env.legal_action_mask(s).numpy()
    acts = np.array([rng.choice(np.nonzero(l)[0]) for l in legal], np.int32)
    return s, torch.from_numpy(acts)


def golden_positions(torch, np):
    from sayuri_tpu_torch.game.state import GoEnv

    data = json.loads((ROOT / "tests/goldens/passdead_goldens.json").read_text())
    n = data["size"]
    env = GoEnv(n=n)
    boards = []
    for rec in data["records"]:
        s = env.new_batch(1, komi=data["komi"])
        for _, v in rec["moves"]:
            s = env.step(s, torch.tensor([n * n if v < 0 else v], dtype=torch.int32))
        if rec["stones"] is not None and s.stones.reshape(-1).tolist() != rec["stones"]:
            raise RuntimeError(f"golden {rec['name']}: replay mismatch")
        boards.append(s.stones)
    stones = torch.cat(boards + boards)
    b = stones.shape[0]
    z = torch.zeros(b, dtype=torch.int32)
    tm = torch.arange(b, dtype=torch.int32) // (b // 2)   # both sides to move
    return stones, z + n, z - 1, tm


def compare(torch, kernel_out, plain_out, tag):
    """Cell-for-cell equality; returns (cells compared, max abs error)."""
    cells, err = 0, 0
    for k, want in plain_out.items():
        got = kernel_out[k].cpu()
        if got.shape != want.shape:
            raise RuntimeError(f"{tag}: {k} shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        cells += diff.numel()
        err = max(err, int(diff.max()) if diff.numel() else 0)
        if err:
            bad = diff.reshape(diff.shape[0], -1).amax(1).nonzero().flatten().tolist()
            raise RuntimeError(f"{tag}: {k} differs in lanes {bad[:16]}")
    return cells, err


def time_card(torch, fn, args, iters=20):
    """ms per call on the card: CUDA events around `iters` calls."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import build

    # ---- 1. device ----
    phase("device")
    card = bench.device_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ----
    phase("build")
    TA._lib()
    print(f"analysis.cu built in {build.BUILD_SECONDS['analysis']:.2f} s "
          f"({build.find_nvcc()})")

    # ---- 3. kernel parity ----
    phase("kernel parity")
    t0 = time.monotonic()
    s19, a19 = random_positions(torch, np, 19, PARITY_B, seed=0, max_moves=260)
    print(f"{PARITY_B} random 19x19 positions in {time.monotonic() - t0:.1f} s")
    gold = golden_positions(torch, np)
    rec = {}
    total_cells = 0
    for tag, args_cpu, fn, plain in (
        ("board_analysis 19x19",
         (s19.stones, s19.size, s19.ko, s19.to_move),
         TA.board_analysis, TA.board_analysis_plain),
        ("step_and_analyze 19x19",
         (s19.stones, s19.size, s19.ko, s19.to_move, a19),
         TA.step_and_analyze, TA.step_and_analyze_plain),
        ("board_analysis goldens 9x9", gold,
         TA.board_analysis, TA.board_analysis_plain),
    ):
        args = tuple(x.to(dev).contiguous() for x in args_cpu)
        want = plain(*args_cpu)
        got = fn(*args)
        torch.cuda.synchronize()
        cells, err = compare(torch, got, want, tag)
        total_cells += cells
        name = fn.__name__
        r = rec.setdefault(name, {"cells": 0, "max_abs_err": 0})
        r["cells"] += cells
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "19x19" in tag:
            t_cpu = time.monotonic()
            plain(*args_cpu)
            r["cpu_plain_ms"] = (time.monotonic() - t_cpu) * 1e3
            r["ms"] = time_card(torch, fn, args)
            r["plain_ms"] = time_card(torch, plain, args, iters=3)
            compare(torch, plain(*args), want, tag + " plain on card")
        print(f"{tag}: {cells} cells equal, max abs err {err}")
    print(f"kernel parity: {total_cells} cells compared, all equal")
    for name, r in rec.items():
        print(f"{name} B={PARITY_B} 19x19: kernel {r['ms']:.4f} ms, plain torch "
              f"on card {r['plain_ms']:.2f} ms, plain torch on CPU "
              f"{r['cpu_plain_ms']:.1f} ms  [{card}]")

    # ---- 4. slice ----
    phase("slice")
    TA.reset_launch_counts()
    res = bench.bench_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev)
    torch.cuda.synchronize()
    launches = dict(TA.LAUNCHES)
    sims = SLICE_PLAYOUTS * res["searches"]
    print(f"launches in the slice run: {launches} ({res['searches']} searches, "
          f"{sims} simulations)")
    if launches["step_and_analyze"] != sims:
        raise RuntimeError(f"step_and_analyze launched {launches['step_and_analyze']}"
                           f" times for {sims} simulations")
    if launches["board_analysis"] < res["searches"]:
        raise RuntimeError("board_analysis launched fewer times than searches")
    tree, mcts = res["tree"], res["mcts"]
    root_visits = tree.visits[:, 0].cpu()
    if not bool((root_visits == SLICE_PLAYOUTS + 1).all()):
        raise RuntimeError(f"root visits {root_visits.unique().tolist()}")
    best = mcts.best_move(tree).cpu()
    legal = mcts.env.legal_action_mask(res["states"].to("cpu"))
    if not bool(legal[torch.arange(SLICE_BATCH), best].all()):
        raise RuntimeError("best_move picked an illegal move")
    child_visits = mcts.root_child_visits(tree).cpu()
    if not bool((child_visits.sum(-1) == SLICE_PLAYOUTS).all()):
        raise RuntimeError("root child visits do not sum to the playouts")
    print(f"{bench.METRIC} = {res['rate']:.1f} playouts/s "
          f"(B={SLICE_BATCH} x {SLICE_PLAYOUTS} playouts, "
          f"{res['searches'] - 1} timed searches in {res['seconds']:.3f} s)  [{card}]")

    # ---- 5. f32 search parity ----
    phase("f32 search parity")
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    env9 = GoEnv(n=9)
    roots, _ = random_positions(torch, np, 9, 8, seed=3, max_moves=30)
    net_cpu = SayuriNet(NetConfig(boardsize=9)).init_random(7).eval()
    net_gpu = SayuriNet(NetConfig(boardsize=9)).init_random(7).to(dev).eval()
    outs = {}
    for where, net, st in (("cpu", net_cpu, roots), ("cuda", net_gpu, roots.to(dev))):
        fn = make_eval_fn(env9, net, symmetry="random", ladder_mode="off")
        m = MCTS(env9, fn, SearchConfig(max_nodes=48, max_depth=32))
        ev = fn(st)
        tree9 = m.run(m.init_tree(st), 32)
        outs[where] = (ev, m.root_child_visits(tree9).cpu(), tree9.visits[:, 0].cpu())
    ev_err = max(
        float((getattr(outs["cpu"][0], k) - getattr(outs["cuda"][0], k).cpu()).abs().max())
        for k in outs["cpu"][0]._fields
    )
    if not ev_err <= EVAL_ATOL:
        raise RuntimeError(f"root NetEvals differ by {ev_err} > {EVAL_ATOL}")
    for where in outs:
        if not bool((outs[where][2] == 33).all()):
            raise RuntimeError(f"{where}: root visits {outs[where][2].tolist()}")
    same = (outs["cpu"][1] == outs["cuda"][1]).all(-1).float().mean().item()
    print(f"root NetEvals max abs err card vs CPU: {ev_err:.3g} (limit {EVAL_ATOL})")
    print(f"lanes with identical root visit vectors: {same:.3f} of 8")

    # ---- result ----
    kernels = []
    for name, line in (("step_and_analyze", 528), ("board_analysis", 451)):
        r = rec[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "sayuri_tpu_torch/csrc/analysis.cu",
            "replaces": f"sayuri_tpu/ops/analysis.py:{line}",
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
