"""The operation and byte counts the mfu and roofline readers divide by,
against a count by hand."""

import json

from conftest import ROOT
from port_bench import peaks


def _net(name):
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())["net"]


def _hand(c, blocks, se_blocks, p=24):
    hw = 361
    convs = 2 * hw * 9 * (43 * c + 2 * blocks * c * c)
    se = se_blocks * 2 * (3 * c * (c // 4) + (c // 4) * 2 * c)
    policy = 2 * hw * (c * p + p * 5) + 2 * (3 * p * p + p * 5)
    value = 2 * hw * (c * p + p) + 2 * (3 * p * 3 * p + 3 * p * 15)
    return convs + se + policy + value


def test_forward_flops_b6c96():
    assert peaks.forward_flops(_net("b6c96")) == _hand(96, 6, 2)
    assert abs(peaks.forward_flops(_net("b6c96")) / 0.75e9 - 1) < 0.01


def test_forward_flops_b15c192():
    assert peaks.forward_flops(_net("b15c192")) == _hand(192, 15, 5)
    assert abs(peaks.forward_flops(_net("b15c192")) / 7.25e9 - 1) < 0.01


def test_forward_bytes_b6c96():
    c, hw, p = 96, 361, 24
    weights = (9 * 43 * c + 12 * 9 * c * c + 2 * (3 * c * 24 + 24 * 2 * c)
               + c * p + 3 * p * p + p * 5 + p * 5 + c * p + 3 * p * 3 * p + p + 3 * p * 15)
    acts = (hw * (43 + c) + 12 * hw * 2 * c + 2 * (3 * c + 24 + 24 + 2 * c)
            + hw * (c + p) + (3 * p + p) + hw * (p + 5) + (p + 5)
            + hw * (c + p) + (3 * p + 3 * p) + hw * (p + 1) + (3 * p + 15))
    assert peaks.forward_bytes(_net("b6c96"), 1024) == 2 * weights + 1024 * 2 * acts
