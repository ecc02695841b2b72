"""Shared set-up of the harness's CPU tests: the repository's root on the
import path, one torch thread a test process (the tests run in several
processes at once), a harness for a cell cut to a size the CPU runs in
seconds (a net of 3 blocks of 16 channels, 6 lanes, all of them judged,
6 playouts), and test-size stacks of the block families the program
builds."""

import json
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every family the program builds, each with and without SE; a mixer spec that
# names V2 before V1 builds V2, as the program's parse reads it
EVERY_FAMILY = ["BottleneckBlock", "NestedBottleneckBlock-SE", "MixerBlock", "MixerBlockV2-SE",
                "ResidualBlock", "MixerBlockV1-SE", "BottleneckBlock-SE",
                "NestedBottleneckBlock", "MixerBlockV2-MixerBlock", "ResidualBlock-SE"]
NESTED = ["NestedBottleneckBlock", "NestedBottleneckBlock-SE"]
# the port's b6c96-mix stack (sayuri_tpu_torch/bench.py NETS), under the RepLK head
MIX = ["BottleneckBlock", "NestedBottleneckBlock-SE", "MixerBlock", "MixerBlockV2-SE",
       "ResidualBlock", "ResidualBlock-SE"]


def tiny_traffic(h):
    """`h` with its traffic cut to the test size."""
    h.wl = dict(h.wl, batch=6, check_lanes=6, max_moves=40)
    if "playouts" in h.wl:
        h.wl.update(playouts=6, root_sets=2)
    return h


def tiny_harness(cell, seed=2**31 + 77, dtype="float32", channels=16, blocks=3, **arch):
    """The cell's harness on the CPU at the test size; `arch` overrides
    the net's keys (a `stack` given there is taken whole)."""
    from port_bench import run as RUN

    h = RUN.Harness(ROOT, json.loads((ROOT / "BENCHMARK.json").read_text()), cell, seed, "cpu")
    net = dict(h.cfg["net"], residual_channels=channels, policy_head_channels=8,
               value_head_channels=8, stack=h.cfg["net"]["stack"][:blocks])
    h.cfg = dict(h.cfg, net=dict(net, **arch), serve_dtype=dtype)
    return tiny_traffic(h)


@pytest.fixture
def tiny():
    return tiny_harness
