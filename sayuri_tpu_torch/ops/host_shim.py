"""Run the kernels of csrc/flood.cu, csrc/analysis.cu and csrc/ladder.cu on
the CPU.

g++ compiles each source, cut before its ``extern "C"`` launchers, against
csrc/host_shim.h (each CUDA thread a fiber, shared memory static, barriers,
warp operations and atomics emulated; see that file), with small C entry
points per source that run a kernel over a batch of boards or lanes. The
wrappers below take and return CPU tensors in the form of the CUDA wrappers
of ops/flood.py, ops/analysis.py and ops/ladder_kernel.py, plus the number
of block barriers each board passed (block-per-board kernels) or of
warp-wide operations each board or lane ran (the flood and the ladder
kernels: a board or a lane is one warp, and the count stands for its serial
latency).

    python -m sayuri_tpu_torch.ops.host_shim [CSRC_DIR ...]

prints, for the kernels of each source directory (default: the package's
csrc/), the barriers a board (the flood: warp-wide operations) over the
256 random 19x19 positions of chip_smoke.py phase 3 (median and maximum)
and over the stress boards of game/positions.py, and the warp-wide
operations of the chase and greedy
kernels on the lanes that ladder_planes_batch gives them on those
positions (the chase: the forked ones): a ply on average and on the
LONGEST_LANES longest lanes (by the plain twins' plies), as one JSON line.
The plain twins take about a minute on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from sayuri_tpu_torch.ops import ladder_kernel as LK
from sayuri_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR

LONGEST_LANES = 8

SHIM_HEADER = CSRC_DIR / "host_shim.h"

_TAIL = "long long* barriers, unsigned long long schedule"
_ENTRY_POINTS = {
    "flood": f"""
extern "C" void shim_labels(const void* mask, void* out, long long boards,
                            int n, {_TAIL}) {{
  shim::launch(boards, threads_for(n), [=] {{
    labels_kernel((const uint8_t*)mask, (long long*)out, n);
  }}, barriers, schedule);
}}
extern "C" int shim_flood_boards_a_block() {{ return FLOOD_WARPS; }}
extern "C" void shim_flood(const void* seed, const void* allowed, void* out,
                           long long boards, int n, {_TAIL},
                           long long* warp_ops) {{
  shim::launch((boards + FLOOD_WARPS - 1) / FLOOD_WARPS, FLOOD_WARPS * 32, [=] {{
    flood_kernel((const uint8_t*)seed, (const uint8_t*)allowed, (bool*)out,
                 boards, n);
  }}, barriers, schedule, warp_ops);
}}
""",
    "analysis": f"""
extern "C" void shim_board_analysis(const void* stones, const void* size,
    const void* ko, const void* to_move, void* legal, void* libs, void* own,
    void* safe, void* sown, int batch, int n, {_TAIL}) {{
  shim::launch(batch, threads_for(n), [=] {{
    board_analysis_kernel((const int8_t*)stones, (const int*)size,
        (const int*)ko, (const int*)to_move, (bool*)legal, (int*)libs,
        (int*)own, (bool*)safe, (int*)sown, n);
  }}, barriers, schedule);
}}
extern "C" void shim_step_analysis(const void* stones, const void* size,
    const void* ko, const void* to_move, const void* action, const void* zob,
    void* new_stones, void* ncap, void* new_ko, void* hash, void* legal,
    void* libs, void* own, void* safe, void* sown, int batch, int n,
    {_TAIL}) {{
  shim::launch(batch, threads_for(n), [=] {{
    step_analysis_kernel((const int8_t*)stones, (const int*)size,
        (const int*)ko, (const int*)to_move, (const int*)action,
        (const int*)zob, (int8_t*)new_stones, (int*)ncap, (int*)new_ko,
        (int*)hash, (bool*)legal, (int*)libs, (int*)own, (bool*)safe,
        (int*)sown, n);
  }}, barriers, schedule);
}}
extern "C" void shim_ladder_prep(const void* stones, const void* size,
    const void* ko, void* labels, void* nlibs, void* lib1, void* lib2,
    void* legal_black, void* legal_white, int batch, int n, {_TAIL}) {{
  shim::launch(batch, threads_for(n), [=] {{
    ladder_prep_kernel((const int8_t*)stones, (const int*)size,
        (const int*)ko, (int*)labels, (int*)nlibs, (int*)lib1, (int*)lib2,
        (bool*)legal_black, (bool*)legal_white, n);
  }}, barriers, schedule);
}}
extern "C" void shim_step_legal(const void* stones, const void* size,
    const void* ko, const void* to_move, const void* action, const void* zob,
    void* new_stones, void* ncap, void* new_ko, void* hash, void* legal,
    int batch, int n, {_TAIL}) {{
  shim::launch(batch, threads_for(n), [=] {{
    step_legal_kernel((const int8_t*)stones, (const int*)size,
        (const int*)ko, (const int*)to_move, (const int*)action,
        (const int*)zob, (int8_t*)new_stones, (int*)ncap, (int*)new_ko,
        (int*)hash, (bool*)legal, n);
  }}, barriers, schedule);
}}
""",
    "ladder": f"""
extern "C" int shim_lanes_a_block() {{ return WARPS; }}
extern "C" void shim_greedy(const void* own, const void* opp, const void* size,
    const void* ko, const void* prey_v, const void* first_v, const void* valid,
    void* result, void* forked, int L, int n, int node_cap, {_TAIL},
    long long* warp_ops) {{
  shim::launch(lane_blocks(L), WARPS * 32, [=] {{
    greedy_kernel((const int*)own, (const int*)opp, (const int*)size,
        (const int*)ko, (const int*)prey_v, (const int*)first_v,
        (const int*)valid, (int*)result, (int*)forked, L, n, node_cap);
  }}, barriers, schedule, warp_ops);
}}
extern "C" void shim_chases(const void* own, const void* opp, const void* size,
    const void* ko, const void* prey_v, const void* first_v, const void* valid,
    void* result, int L, int n, int node_cap, int max_forks, {_TAIL},
    long long* warp_ops) {{
  shim::launch(lane_blocks(L), WARPS * 32, [=] {{
    chase_kernel((const int*)own, (const int*)opp, (const int*)size,
        (const int*)ko, (const int*)prey_v, (const int*)first_v,
        (const int*)valid, (int*)result, L, n, node_cap, max_forks);
  }}, barriers, schedule, warp_ops);
}}
""",
}


def find_cxx() -> str | None:
    """Path of g++ (or $CXX), None when there is none."""
    return shutil.which(os.environ.get("CXX", "g++"))


def _cut(src: str) -> str:
    """The source up to its first extern "C" launcher."""
    cut = src.find('\nextern "C"')
    return src if cut < 0 else src[:cut + 1]


@functools.lru_cache(maxsize=None)
def build(csrc: str | Path = CSRC_DIR) -> ctypes.CDLL:
    """Compile flood.cu, analysis.cu and ladder.cu of `csrc` against the
    shim into one shared library (cached under _build/ by the hash of its
    inputs) and load it."""
    csrc = Path(csrc).resolve()
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("host_shim: no C++ compiler (g++ or $CXX)")
    units = {name: _cut((csrc / f"{name}.cu").read_text()) + _ENTRY_POINTS[name]
             for name in _ENTRY_POINTS}
    key = hashlib.sha256()
    for text in (*units.values(), SHIM_HEADER.read_text(),
                 *(p.read_text() for p in sorted(csrc.glob("*.cuh")))):
        key.update(text.encode())
    out_dir = BUILD_DIR / f"shim-{key.hexdigest()[:16]}"
    lib = out_dir / "libshim.so"
    if not lib.exists():
        (out_dir / "inc").mkdir(parents=True, exist_ok=True)
        (out_dir / "inc" / "cuda_runtime.h").write_text(
            f'#pragma once\n#include "{SHIM_HEADER}"\n')
        cpps = []
        for name, text in units.items():
            cpp = out_dir / f"{name}.cpp"
            cpp.write_text(text)
            cpps.append(str(cpp))
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
               "-U_FORTIFY_SOURCE", "-I", str(out_dir / "inc"), "-I", str(csrc),
               "-o", str(tmp), *cpps]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"host_shim: g++ failed (rc={res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _run(fn, *args, boards, schedule):
    barriers = torch.zeros(boards, dtype=torch.int64)
    fn(*args, _p(barriers), ctypes.c_ulonglong(schedule))
    return barriers


def _lead(t):
    n = t.shape[-1]
    return t.numel() // (n * n), n


def chain_labels(lib, mask, schedule=0):
    """labels_kernel on [..., n, n] bool -> (int64 labels, barriers)."""
    mask = mask.contiguous()
    boards, n = _lead(mask)
    out = torch.empty(mask.shape, dtype=torch.int64)
    bar = _run(lib.shim_labels, _p(mask), _p(out), ctypes.c_longlong(boards),
               ctypes.c_int(n), boards=boards, schedule=schedule)
    return out, bar


def flood(lib, seed, allowed, schedule=0):
    """flood_kernel on [..., n, n] bool -> (bool flood, warp-wide operations
    of each board: a board is one warp, and the count stands for its serial
    latency). The kernel passes no block barrier."""
    seed, allowed = seed.contiguous(), allowed.contiguous()
    boards, n = _lead(allowed)
    out = torch.empty_like(allowed)
    per_block = lib.shim_flood_boards_a_block()
    blocks = -(-boards // per_block)
    ops = torch.zeros(blocks * per_block, dtype=torch.int64)
    barriers = torch.zeros(blocks, dtype=torch.int64)
    lib.shim_flood(_p(seed), _p(allowed), _p(out), ctypes.c_longlong(boards),
                   ctypes.c_int(n), _p(barriers), ctypes.c_ulonglong(schedule), _p(ops))
    if barriers.any():
        raise RuntimeError("flood_kernel passed a block barrier")
    return out, ops[:boards]


def _analysis_out(b, n):
    return {"legal": torch.empty((b, n * n), dtype=torch.bool),
            "libs": torch.empty((b, n, n), dtype=torch.int32),
            "ownership": torch.empty((b, n, n), dtype=torch.int32),
            "safe": torch.empty((b, n, n), dtype=torch.bool),
            "score_ownership": torch.empty((b, n, n), dtype=torch.int32)}


def _step_out(b, n):
    return {"new_stones": torch.empty((b, n, n), dtype=torch.int8),
            "n_captured": torch.empty((b,), dtype=torch.int32),
            "new_ko": torch.empty((b,), dtype=torch.int32),
            "new_hash": torch.empty((b, 2), dtype=torch.int32)}


def _inputs(*ts):
    return tuple(_p(t.contiguous()) for t in ts)


def _zob(n):
    from sayuri_tpu_torch.ops.analysis import _zobrist_rows

    return _zobrist_rows(n, "cpu")


def board_analysis(lib, stones, size, ko, to_move, schedule=0):
    """board_analysis_kernel -> (the dict of ops.analysis.board_analysis,
    barriers)."""
    b, n = stones.shape[0], stones.shape[-1]
    out = _analysis_out(b, n)
    bar = _run(lib.shim_board_analysis, *_inputs(stones, size, ko, to_move),
               *(_p(t) for t in out.values()), ctypes.c_int(b), ctypes.c_int(n),
               boards=b, schedule=schedule)
    return out, bar


def step_and_analyze(lib, stones, size, ko, to_move, action, schedule=0):
    """step_analysis_kernel -> (the dict of ops.analysis.step_and_analyze,
    barriers)."""
    b, n = stones.shape[0], stones.shape[-1]
    step, ana = _step_out(b, n), _analysis_out(b, n)
    bar = _run(lib.shim_step_analysis,
               *_inputs(stones, size, ko, to_move, action, _zob(n)),
               *(_p(t) for t in (*step.values(), *ana.values())),
               ctypes.c_int(b), ctypes.c_int(n), boards=b, schedule=schedule)
    step["new_hash"] = step["new_hash"].to(torch.int64) & 0xFFFFFFFF
    return {**step, **ana}, bar


def ladder_prep(lib, stones, size, ko, schedule=0):
    """ladder_prep_kernel -> (the dict of ops.analysis.ladder_prep,
    barriers)."""
    b, n = stones.shape[0], stones.shape[-1]
    out = {k: torch.empty((b, n * n), dtype=torch.int32)
           for k in ("labels", "nlibs", "lib1", "lib2")}
    out.update({k: torch.empty((b, n * n), dtype=torch.bool)
                for k in ("legal_black", "legal_white")})
    bar = _run(lib.shim_ladder_prep, *_inputs(stones, size, ko),
               *(_p(t) for t in out.values()), ctypes.c_int(b), ctypes.c_int(n),
               boards=b, schedule=schedule)
    return out, bar


def step_and_legal(lib, stones, size, ko, to_move, action, schedule=0):
    """step_legal_kernel -> (the dict of ops.analysis.step_and_legal,
    barriers)."""
    b, n = stones.shape[0], stones.shape[-1]
    step = _step_out(b, n)
    legal = torch.empty((b, n * n), dtype=torch.bool)
    bar = _run(lib.shim_step_legal,
               *_inputs(stones, size, ko, to_move, action, _zob(n)),
               *(_p(t) for t in step.values()), _p(legal),
               ctypes.c_int(b), ctypes.c_int(n), boards=b, schedule=schedule)
    step["new_hash"] = step["new_hash"].to(torch.int64) & 0xFFFFFFFF
    return {**step, "legal": legal}, bar


def _ladder_run(fn, lib, lanes, n, *tail, outputs, schedule):
    """Runs a ladder entry point over the seven lane inputs; returns its
    int32 outputs and the warp-wide operations of each lane."""
    L = lanes[0].shape[0]
    outs = [torch.empty(L, dtype=torch.int32) for _ in range(outputs)]
    blocks = -(-L // lib.shim_lanes_a_block())
    ops = torch.zeros(blocks * lib.shim_lanes_a_block(), dtype=torch.int64)
    barriers = torch.zeros(blocks, dtype=torch.int64)
    fn(*_inputs(*lanes), *(_p(t) for t in outs), ctypes.c_int(L), ctypes.c_int(n),
       *(ctypes.c_int(x) for x in tail), _p(barriers), ctypes.c_ulonglong(schedule),
       _p(ops))
    return outs, ops[:L]


def run_greedy(lib, lanes, n, node_cap=LK.NODE_CAP, schedule=0):
    """greedy_kernel on the seven lane inputs of ops.ladder_kernel.run_greedy
    -> (result, forked, warp-wide operations of each lane)."""
    (result, forked), ops = _ladder_run(lib.shim_greedy, lib, lanes, n, node_cap,
                                        outputs=2, schedule=schedule)
    return result, forked, ops


def run_chases(lib, lanes, n, node_cap=LK.NODE_CAP, max_forks=LK.MAX_FORKS,
               schedule=0):
    """chase_kernel on the seven lane inputs of ops.ladder_kernel.run_chases
    -> (result, warp-wide operations of each lane)."""
    (result,), ops = _ladder_run(lib.shim_chases, lib, lanes, n, node_cap, max_forks,
                                 outputs=1, schedule=schedule)
    return result, ops


def search_lanes(stones, size, ko):
    """The lanes that ladder_planes_batch hands the two search kernels on a
    batch of CPU positions, through the plain twins: (greedy lanes, chase
    lanes), seven tensors each (the chase's `valid` marks the forked
    lanes)."""
    from sayuri_tpu_torch.game.ladder import chase_lanes

    n = stones.shape[-1]
    args, ok = chase_lanes(stones, size, ko)[2:]
    ok = ok.to(torch.int32)
    _, forked = LK.run_greedy_plain(*args, ok, n)
    return (*args, ok), (*args, ((forked > 0) & (ok > 0)).to(torch.int32))


def colour_masks(stones, size):
    """[3, B, n, n] bool: the empty, black and white cells on the board."""
    from sayuri_tpu_torch.game import board as B

    mask = B.board_mask(size, stones.shape[-1])
    return torch.stack([(stones == c) & mask for c in (0, 1, 2)])


def barrier_counts(lib, args):
    """Barriers a board of each block-per-board kernel on (stones, size, ko,
    to_move, action), and the flood's warp-wide operations a board:
    {kernel: [count per board]} (labels and flood over the colour masks,
    the flood seeded by the cells next to an empty one)."""
    from sayuri_tpu_torch.game import board as B

    stones, size, ko, to_move, action = args
    masks = colour_masks(stones, size)
    seeds = masks & B.nbr_or(masks[0])
    return {
        "step_and_analyze": step_and_analyze(lib, *args)[1].tolist(),
        "board_analysis": board_analysis(lib, *args[:4])[1].tolist(),
        "step_and_legal": step_and_legal(lib, *args)[1].tolist(),
        "ladder_prep": ladder_prep(lib, *args[:3])[1].tolist(),
        "chain_labels": chain_labels(lib, masks)[1].tolist(),
        "flood (warp ops)": flood(lib, seeds, masks)[1].tolist(),
    }


def _summary(counts):
    import statistics

    return {k: {"median": statistics.median(v), "max": max(v), "boards": len(v)}
            for k, v in counts.items()}


def lane_report(ops, plies):
    """A ladder kernel's warp-wide operations over the searched lanes (`ops`
    and the plain twin's `plies` of each lane, 0 where a lane is not
    searched): their mean a ply, and [ops, plies] of the LONGEST_LANES
    lanes with the most plies."""
    top = torch.argsort(plies, descending=True, stable=True)[:LONGEST_LANES]
    return {"warp ops a ply": round(ops.sum().item() / plies.sum().item(), 1),
            "longest lanes [warp ops, plies]": torch.stack([ops[top], plies[top]], 1).tolist()}


def main(argv):
    from sayuri_tpu_torch.game.positions import random_positions, stress_positions

    dirs = argv or [str(CSRC_DIR)]
    s, a = random_positions(19, 256, seed=0, max_moves=260)
    random_args = (s.stones, s.size, s.ko, s.to_move, a)
    stress_args = stress_positions(19)[:5]
    g_lanes, c_lanes = search_lanes(s.stones, s.size, s.ko)
    n = s.stones.shape[-1]
    g_steps = LK.greedy_steps_plain(*g_lanes, n)[2]
    c_descents = LK.chase_descents_plain(*c_lanes, n)[1]
    report = {}
    for d in dirs:
        lib = build(d)
        report[d] = {
            "phase-3 positions (256 random 19x19)": _summary(barrier_counts(lib, random_args)),
            "stress boards 19x19": _summary(barrier_counts(lib, stress_args)),
            "run_chases on its forked lanes (plies: descents)":
                lane_report(run_chases(lib, c_lanes, n)[1], c_descents),
            "run_greedy on its valid lanes (plies: steps)":
                lane_report(run_greedy(lib, g_lanes, n)[2], g_steps),
        }
    print(json.dumps(report))


if __name__ == "__main__":
    main(sys.argv[1:])
