"""Shared set-up of the harness's CPU tests: the repository's root on the
import path, one torch thread a test process (the tests run in several
processes at once), and a harness for a cell cut to a size the CPU runs in
seconds (a net of 3 blocks of 16 channels, 6 lanes, all of them judged,
6 playouts)."""

import json
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_harness(cell, seed=2**31 + 77, dtype="float32", channels=16, blocks=3):
    from port_bench import run as RUN

    h = RUN.Harness(ROOT, json.loads((ROOT / "BENCHMARK.json").read_text()), cell, seed, "cpu")
    net = dict(h.cfg["net"], residual_channels=channels, policy_head_channels=8,
               value_head_channels=8, stack=h.cfg["net"]["stack"][:blocks])
    h.cfg = dict(h.cfg, net=net, serve_dtype=dtype)
    h.wl = dict(h.wl, batch=6, check_lanes=6, max_moves=40)
    if "playouts" in h.wl:
        h.wl.update(playouts=6, root_sets=2)
    return h


@pytest.fixture
def tiny():
    return tiny_harness
