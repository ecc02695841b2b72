"""Readings of a cell's compared numbers for the program and for its
control, seed by seed in one process: the lower and upper readings its
limits are set from.

    python port_bench/control.py --workload NAME --seconds S --seeds N [N ...] [--control fp8]

For each seed: the cell's set-up and a window of `--seconds` (at the
cell's own sizes), then the reference judges the program's outputs and,
on the same positions, the control's: the plain net computed in the
nearest precision below the one the configuration serves in (float8 e4m3
below bfloat16), standing in for the program. One JSON line a seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)

from port_bench import run as RUN  # noqa: E402


def readings(h, seconds, control, sync, window=None):
    """(program's readings, control's readings) of one seed; `window`, a
    dict, gets the units run and their seconds."""
    import torch

    cell = h.driver().setup(h)
    sync()
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds:
        cell.unit()
        sync()
        units += 1
    if window is not None:
        window.update(units=units, seconds=time.perf_counter() - t0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    data = cell.collect()
    return cell.judge(data), cell.judge(data, control)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="fp8")
    args = ap.parse_args(argv)
    RUN.fixed_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("port_bench control: no CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        h = RUN.Harness(ROOT, bench, args.workload, seed, "cuda")
        window = {}
        prog, ctrl = readings(h, args.seconds, args.control, torch.cuda.synchronize, window)
        print(json.dumps({"workload": args.workload, "seed": seed, "window": window,
                          "program": prog, "control": ctrl}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
