"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout. Everything is found by name:
BENCHMARK.json's workload entry names the configuration
(port_bench/configs/<config>.json) and the traffic
(port_bench/workloads/<traffic>.json), which names its driver
(port_bench/drivers/<driver>.py); the cell's limits on the numbers the
reference compares are port_bench/limits/<workload>.json; each per-layer
metric has its reader (port_bench/metrics/<metric>.py). Adding a cell, a configuration or a
metric adds files and entries and edits none.

A run: set-up (weights and inputs from the seed, the program built and
warmed on the cell's shapes), then timed units (a search, a move) until
`--seconds` have passed. With `--trace 1` the window is one unit, then one
more unit runs under the profiler, read by the per-layer readers (a
traced self-play move holds about a million kernels, and reading them
takes minutes). Then the device's peak memory is
read, the program's state freed, and the plain reference judges what the
timed path produced; each number compared is printed beside its limit,
last on standard error and under "limits" in the result, which is the
last line of standard output. No card, too few cards, a module of JAX or
of the JAX package loaded, or a file missing: no result and a non-zero
exit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a script: import the harness as a package from the checkout's root,
# never its modules by their bare names
if sys.path and Path(sys.path[0]).resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sayuri_tpu"}


def process_age():
    """Seconds since this process started (Linux /proc)."""
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    return float(Path("/proc/uptime").read_text().split()[0]) - start / os.sysconf("SC_CLK_TCK")


def fixed_caches(root):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = Path(root) / ".cache" / "port_bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Harness:
    """What a driver gets: the configuration, the workload, the seed, the
    device and the checkout's root."""

    def __init__(self, root, bench, workload, seed, device, limits=None):
        self.root = Path(root)
        self.bench = bench
        self.cell = next(w for w in bench["workloads"] if w["name"] == workload)
        entry = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.cfg = json.loads((self.root / entry["file"]).read_text())
        pb = self.root / "port_bench"
        self.wl = json.loads((pb / "workloads" / f"{self.cell['traffic']}.json").read_text())
        self.limits = limits or json.loads((pb / "limits" / f"{workload}.json").read_text())
        self.seed = seed
        self.device = device

    def driver(self):
        return importlib.import_module(f"port_bench.drivers.{self.wl['driver']}")

    def end_to_end(self):
        """This cell's end-to-end metrics."""
        return [m for m in self.bench["end_to_end"]
                if self.cell["name"] in m.get("workloads", [self.cell["name"]])]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def judge(self, readings):
        """(correct, {name: {value, limit}}) against the workload's limits."""
        out = {k: {"value": readings[k], "limit": lim} for k, lim in self.limits.items()}
        return all(v["value"] <= v["limit"] for v in out.values()), out


class Context:
    """What a per-layer reader gets."""

    def __init__(self, h, trace, unit, totals, window_s):
        from port_bench import peaks

        self.h, self.trace, self.unit, self.totals, self.window_s = h, trace, unit, totals, window_s
        self.net = h.cfg["net"]
        self.peaks = peaks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches(ROOT)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    h = Harness(ROOT, bench, args.workload, args.seed, "cuda")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < h.cell["chips"]:
        sys.exit(f"port_bench: the cell needs {h.cell['chips']} CUDA device(s); "
                 f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from port_bench import peaks

    name, limit = peaks.card()
    print(f"card: {name}, power limit {limit}", file=sys.stderr)
    result = run_cell(h, args.seconds, args.trace, torch.cuda.synchronize)
    bad = forbidden_modules()
    if bad:
        sys.exit(f"port_bench: modules of JAX or the JAX package were loaded: {bad}")
    for k, v in result["limits"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))


def run_cell(h, seconds, traced, sync):
    """Set-up, the window, the traced unit and the check of one cell on
    `h.device`; returns the result dict."""
    import torch

    from port_bench import trace

    cell = h.driver().setup(h)
    sync()
    setup_s = process_age()
    totals, unit_s = {}, []
    t0 = time.perf_counter()
    while True:
        for k, v in cell.unit().items():
            totals[k] = totals.get(k, 0) + v
        sync()
        unit_s.append(time.perf_counter() - t0 - sum(unit_s))
        window_s = time.perf_counter() - t0
        # a traced run's window is one unit: its counts are the per-layer
        # readers' base, and the traced unit follows
        if traced or window_s >= seconds:
            break
    if hasattr(cell, "totals"):
        totals.update(cell.totals())
    metrics, extra = {}, {}
    if traced:
        unit, tr = trace.run_traced(cell.unit, sync)
        ctx = Context(h, tr, unit, totals, window_s)
        for m in h.per_layer():
            value = load(h.root / "port_bench" / "metrics" / f"{m['name']}.py",
                         "port_bench_metric").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {"busy_s": tr.busy_us / 1e6, "window_s": tr.window_us / 1e6}
        extra["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_host()}
    else:
        device = {}
        for m in h.end_to_end():
            value = setup_s if m["name"] == "setup_s" else totals[h.wl["rate"][m["name"]]] / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = torch.device(h.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # the reference computes in float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    readings = cell.check()
    correct, compared = h.judge(readings)
    print(json.dumps({"setup_s": setup_s, "totals": totals, "window_s": window_s,
                      "unit_s": unit_s, "readings": readings}), file=sys.stderr)
    return {"correct": correct, "attempted": len(unit_s), "failed": 0, "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "count": h.cell["chips"], "memory_peak_bytes": peak, **device},
            **extra, "limits": compared}


if __name__ == "__main__":
    main()
