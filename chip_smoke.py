#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sayuri_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit; TF32 off for the f32 phases.
2. build: compile csrc/analysis.cu and csrc/ladder.cu with nvcc for sm_90a
   (first use, both nvcc processes at once); ptxas resources printed.
3. kernel parity: random legal 19x19 positions (B=256, numpy seed) plus
   the pass-dead golden boards, through both analysis kernels and their
   plain twins on the CPU: every output equal cell for cell; kernel and
   plain version timed on the card at B=256.
4. ladder kernel parity: the same 256 positions plus the 54 records of
   tests/goldens/go_goldens_19.json. ladder_prep, run_greedy and run_chases
   equal their plain twins cell for cell and lane for lane (the lanes that
   ladder_planes_batch builds); ladder_planes_batch on the card equals the
   plain one on the CPU; on the goldens the four planes equal the
   reference's encoder planes 33-36. Kernels and plain versions timed on
   the card at B=256.
5. slice: bench_playouts(256, 96) (19x19, b6c96, bf16, random symmetry,
   root ladder planes), one warm-up search and three timed; launch counters
   prove the main path ran through all five kernels, each ladder kernel
   once per search.
6. midgame roots: the same bench from the 256 positions of phase 3 (one
   warm-up search, one timed): root ladder planes non-zero and equal to the
   CPU twin's, root visits = playouts + 1, legal best moves.
7. f32 search parity: 9x9 midgame roots with root ladder planes, B=8, 32
   playouts, the same seeded weights on the card and on the CPU (twins):
   root NetEvals within 1e-4, share of lanes with identical root visit
   vectors reported.

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}. There is no CPU fallback: without a CUDA
device the script fails.
"""

import json
import re
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


def time_card(torch, fn, args, iters=20, warmup=2):
    """ms per call on the card: CUDA events around `iters` calls."""
    for _ in range(warmup):
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


def golden19_positions(torch):
    """The 54 records of go_goldens_19.json replayed with the port's plain
    env in one batch (a lane stops after its last move). Returns (states,
    reference ladder planes [B, n, n, 4] in encoder order 33-36)."""
    from sayuri_tpu_torch.game.state import GoEnv, GoState

    data = json.loads((ROOT / "tests/goldens/go_goldens_19.json").read_text())
    records = data["records"]
    n, b = data["size"], len(records)
    env = GoEnv(n=n)
    s = env.new_batch(b, komi=data["komi"])
    moves = [r["moves"] for r in records]
    for t in range(max(len(m) for m in moves)):
        active = torch.tensor([t < len(m) for m in moves])
        acts = torch.tensor([n * n if t >= len(m) or m[t] == "pass" else int(m[t])
                             for m in moves], dtype=torch.int32)
        new = env.step(s, acts)
        s = GoState(**{
            k: torch.where(active.view((b,) + (1,) * (v.ndim - 1)), v, getattr(s, k))
            for k, v in new.fields().items()
        })
    planes = torch.tensor([r["planes"][33:37] for r in records]).permute(0, 2, 3, 1)
    return s, planes


class LaneSpy:
    """Records the arguments and results of the ladder search wrappers
    while ladder_planes_batch runs (to replay the same lanes through the
    kernels)."""

    def __init__(self, LK):
        self.LK = LK
        self.calls = {}

    def __enter__(self):
        self.real = {k: getattr(self.LK, k) for k in ("run_greedy", "run_chases")}
        for name, fn in self.real.items():
            def spy(*args, _fn=fn, _name=name, **kw):
                out = _fn(*args, **kw)
                self.calls[_name] = (args, out)
                return out
            setattr(self.LK, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.LK, name, fn)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.game import ladder as TL
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import build
    from sayuri_tpu_torch.ops import ladder_kernel as LK

    def reset_counts():
        TA.reset_launch_counts()
        LK.reset_launch_counts()

    def counts():
        return {**TA.LAUNCHES, **LK.LAUNCHES}

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
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda f: f(), (TA._lib, LK._lib)))
    for name in ("analysis", "ladder"):
        print(f"{name}.cu built in {build.BUILD_SECONDS[name]:.2f} s "
              f"({build.find_nvcc()})")
        ptxas = (build.BUILD_DIR / f"lib{name}.ptxas.txt").read_text().splitlines()
        for line in ptxas:
            if "Compiling entry" in line:
                print("  " + re.search(r"\d([a-z_]+_kernel)E", line).group(1))
            elif "Used" in line or "spill" in line:
                print("    " + line.strip())

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

    # ---- 4. ladder kernel parity ----
    phase("ladder kernel parity")
    t0 = time.monotonic()
    g19, gold_planes = golden19_positions(torch)
    print(f"{g19.stones.shape[0]} 19x19 golden records replayed in "
          f"{time.monotonic() - t0:.1f} s")
    ladder_rec = {k: {"cells": 0, "max_abs_err": 0} for k in
                  ("ladder_prep", "run_greedy", "run_chases")}
    cpu_planes = {}
    for tag, st in (("random", s19), ("goldens", g19)):
        args_cpu = (st.stones, st.size, st.ko)
        args = tuple(x.to(dev).contiguous() for x in args_cpu)
        want = TA.ladder_prep_plain(*args_cpu)
        cells, err = compare(torch, TA.ladder_prep(*args), want, f"ladder_prep {tag}")
        ladder_rec["ladder_prep"]["cells"] += cells
        t_cpu = time.monotonic()
        with LaneSpy(LK) as spy:
            cpu_planes[tag] = TL.ladder_planes_batch(*args_cpu)
        cpu_s = time.monotonic() - t_cpu
        g_args, (g_res, g_forked) = spy.calls["run_greedy"]
        c_args, c_res = spy.calls["run_chases"]
        n = st.stones.shape[-1]
        g_dev = tuple(x.to(dev) for x in g_args[:7])
        c_dev = tuple(x.to(dev) for x in c_args[:7])
        k_res, k_forked = LK.run_greedy(*g_dev, n)
        cells, _ = compare(torch, {"result": k_res, "forked": k_forked},
                           {"result": g_res, "forked": g_forked}, f"run_greedy {tag}")
        ladder_rec["run_greedy"]["cells"] += cells
        cells, _ = compare(torch, {"result": LK.run_chases(*c_dev, n)},
                           {"result": c_res}, f"run_chases {tag}")
        ladder_rec["run_chases"]["cells"] += cells
        got_planes = TL.ladder_planes_batch(*args)
        compare(torch, {"planes": got_planes}, {"planes": cpu_planes[tag]},
                f"ladder_planes_batch {tag}")
        active, forked = int((g_args[6] > 0).sum()), int((c_args[6] > 0).sum())
        boards = int((cpu_planes[tag].sum((1, 2, 3)) > 0).sum())
        print(f"{tag}: B={st.stones.shape[0]}, {g_args[0].shape[0]} lanes, {active} "
              f"active, {forked} forked; planes equal, {boards} boards with marks; "
              f"plain ladder_planes_batch on CPU {cpu_s:.1f} s")
        if tag == "goldens":
            compare(torch, {"planes": got_planes}, {"planes": gold_planes},
                    "ladder planes vs golden planes 33-36")
            print(f"goldens: planes 33-36 equal the reference's on "
                  f"{int(gold_planes.sum())} marked cells")
        else:
            lanes_b256 = (args, g_dev, c_dev, n)
    args, g_dev, c_dev, n = lanes_b256
    timed = (
        ("ladder_prep", TA.ladder_prep, TA.ladder_prep_plain, args),
        ("run_greedy", lambda *a: LK.run_greedy(*a, n),
         lambda *a: LK.run_greedy_plain(*a, n), g_dev),
        ("run_chases", lambda *a: LK.run_chases(*a, n),
         lambda *a: LK.run_chases_plain(*a, n), c_dev),
    )
    for name, fn, plain, a in timed:
        r = ladder_rec[name]
        r["ms"] = time_card(torch, fn, a)
        r["plain_ms"] = time_card(torch, plain, a, iters=1, warmup=0)
        rec[name] = r
        print(f"{name} B={PARITY_B} 19x19: kernel {r['ms']:.4f} ms, plain torch on "
              f"card {r['plain_ms']:.2f} ms, {r['cells']} outputs equal  [{card}]")
    planes_ms = time_card(torch, TL.ladder_planes_batch, args, iters=5)
    print(f"ladder_planes_batch B={PARITY_B} 19x19 (prep, candidates, both "
          f"searches, planes): {planes_ms:.3f} ms on the card  [{card}]")

    def check_roots(res, tag):
        tree, mcts, batch = res["tree"], res["mcts"], res["states"].stones.shape[0]
        root_visits = tree.visits[:, 0].cpu()
        if not bool((root_visits == SLICE_PLAYOUTS + 1).all()):
            raise RuntimeError(f"{tag}: root visits {root_visits.unique().tolist()}")
        best = mcts.best_move(tree).cpu()
        legal = mcts.env.legal_action_mask(res["states"].to("cpu"))
        if not bool(legal[torch.arange(batch), best].all()):
            raise RuntimeError(f"{tag}: best_move picked an illegal move")
        child_visits = mcts.root_child_visits(tree).cpu()
        if not bool((child_visits.sum(-1) == SLICE_PLAYOUTS).all()):
            raise RuntimeError(f"{tag}: root child visits do not sum to the playouts")

    def check_launches(launches, res, tag):
        searches = res["searches"]
        sims = SLICE_PLAYOUTS * searches
        print(f"launches in the {tag} run: {launches} ({searches} searches, "
              f"{sims} simulations)")
        if launches["step_and_analyze"] != sims:
            raise RuntimeError(f"{tag}: step_and_analyze launched "
                               f"{launches['step_and_analyze']} times for {sims} simulations")
        if launches["board_analysis"] < searches:
            raise RuntimeError(f"{tag}: board_analysis launched fewer times than searches")
        for k in ("ladder_prep", "run_greedy", "run_chases"):
            if launches[k] != searches:
                raise RuntimeError(f"{tag}: {k} launched {launches[k]} times for "
                                   f"{searches} searches")

    # ---- 5. slice ----
    phase("slice")
    reset_counts()
    res = bench.bench_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev)
    torch.cuda.synchronize()
    launches = counts()
    check_launches(launches, res, "slice")
    check_roots(res, "slice")
    empty_rate = res["rate"]
    print(f"{bench.METRIC} = {empty_rate:.1f} playouts/s "
          f"(B={SLICE_BATCH} x {SLICE_PLAYOUTS} playouts, empty roots, "
          f"{res['searches'] - 1} timed searches in {res['seconds']:.3f} s)  [{card}]")

    # ---- 6. midgame roots ----
    phase("midgame roots")
    reset_counts()
    res = bench.bench_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev, iters=1,
                               roots=s19)
    torch.cuda.synchronize()
    check_launches(counts(), res, "midgame")
    check_roots(res, "midgame")
    st = res["states"]
    root_planes = TL.ladder_planes_batch(st.stones, st.size, st.ko)
    compare(torch, {"planes": root_planes}, {"planes": cpu_planes["random"]},
            "midgame root ladder planes")
    marked = int((root_planes.sum((1, 2, 3)) > 0).sum())
    if marked == 0:
        raise RuntimeError("midgame roots: no root ladder planes")
    print(f"midgame roots: {marked} of {SLICE_BATCH} boards with ladder marks, equal "
          f"to the CPU twin's; {res['rate']:.1f} playouts/s from midgame roots "
          f"({res['seconds']:.3f} s) vs {empty_rate:.1f} from empty roots  [{card}]")

    # ---- 7. f32 search parity ----
    phase("f32 search parity")
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    env9 = GoEnv(n=9)
    roots, _ = random_positions(torch, np, 9, 8, seed=3, max_moves=50)
    net_cpu = SayuriNet(NetConfig(boardsize=9)).init_random(7).eval()
    net_gpu = SayuriNet(NetConfig(boardsize=9)).init_random(7).to(dev).eval()
    outs = {}
    for where, net, st in (("cpu", net_cpu, roots), ("cuda", net_gpu, roots.to(dev))):
        fn = make_eval_fn(env9, net, symmetry="random", ladder_mode="root")
        m = MCTS(env9, fn, SearchConfig(max_nodes=48, max_depth=32))
        ctx = {"ladders": TL.ladder_planes_batch(st.stones, st.size, st.ko)}
        ev = fn(st, ctx)
        tree9 = m.run(m.init_tree(st, ctx), 32, ctx)
        outs[where] = (ev, m.root_child_visits(tree9).cpu(), tree9.visits[:, 0].cpu(),
                       ctx["ladders"].cpu())
    compare(torch, {"planes": outs["cuda"][3]}, {"planes": outs["cpu"][3]},
            "9x9 root ladder planes")
    if not outs["cpu"][3].sum() > 0:
        raise RuntimeError("9x9 roots: no ladder marks")
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
    print(f"9x9 midgame roots, {int((outs['cpu'][3].sum((1, 2, 3)) > 0).sum())} of 8 "
          f"with ladder marks")
    print(f"root NetEvals max abs err card vs CPU: {ev_err:.3g} (limit {EVAL_ATOL})")
    print(f"lanes with identical root visit vectors: {same:.3f} of 8")

    # ---- result ----
    kernels = []
    for name, src, replaces in (
        ("step_and_analyze", "analysis.cu", "sayuri_tpu/ops/analysis.py:528"),
        ("board_analysis", "analysis.cu", "sayuri_tpu/ops/analysis.py:451"),
        ("ladder_prep", "analysis.cu", "sayuri_tpu/ops/analysis.py:718"),
        ("run_greedy", "ladder.cu", "sayuri_tpu/ops/ladder_kernel.py:743"),
        ("run_chases", "ladder.cu", "sayuri_tpu/ops/ladder_kernel.py:824"),
    ):
        r = rec[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"sayuri_tpu_torch/csrc/{src}",
            "replaces": replaces,
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
