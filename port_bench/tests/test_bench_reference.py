"""The plain reference: its encoder commutes with the board's symmetries,
its evaluation under a symmetry is the evaluation of the transformed
position, and in float32 on the CPU its net gives the measured program's
outputs on the same weights."""

import pytest
import torch

from port_bench import roots
from port_bench.reference import check as RC
from port_bench.reference import frozen as R
from port_bench.reference import net as N
from port_bench.reference import rules as RU

NET = {"boardsize": 19, "input_channels": 43, "residual_channels": 16,
       "stack": ["ResidualBlock", "ResidualBlock-SE"], "se_ratio": 4,
       "policy_head_channels": 8, "value_head_channels": 8, "policy_head_type": "Normal",
       "activation": "relu", "policy_outs": 5, "value_misc": 15}


def _map(v, sym, n=19):
    y, x = v // n, v % n
    if sym & 4:
        y, x = x, y
    if sym & 2:
        y = n - 1 - y
    if sym & 1:
        x = n - 1 - x
    return torch.where(v >= 0, y * n + x, v)


def _planes(moves, counts):
    s, _, illegal = RC.replay(moves, counts, torch.tensor([0, 1, 0, 1]), 7.5, "cpu")
    assert illegal == 0
    lad = R.ladder_planes_batch(s.stones, RU.size_of(s), s.ko.to(torch.int32))
    return s, RU.encode(s, lad, RU.analysis(s))


@pytest.mark.parametrize("sym", range(8))
def test_encoder_commutes_with_symmetry(sym):
    moves, counts = roots.midgame(4, 2**31 + 99, "cpu", max_moves=40)
    _, planes = _planes(moves, counts)
    _, moved = _planes(_map(moves, sym), counts)
    assert torch.equal(moved, R.transform_planes_batch(planes, torch.full((4,), sym)))


@pytest.mark.parametrize("sym", range(8))
def test_net_under_symmetry_is_net_of_transformed_position(sym):
    moves, counts = roots.midgame(4, 2**31 + 98, "cpu", max_moves=40)
    w = N.make_weights(NET, 7, "cpu")
    _, planes = _planes(moves, counts)
    syms = torch.full((4,), sym)
    logits, wdl = N.forward(NET, w, R.transform_planes_batch(planes, syms))
    _, moved = _planes(_map(moves, sym), counts)
    logits2, wdl2 = N.forward(NET, w, moved)
    assert torch.allclose(wdl, wdl2, atol=1e-5)
    assert torch.allclose(logits, logits2, atol=1e-4)


@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_reference_net_is_the_programs_in_float32(activation):
    from port_bench import program

    net = dict(NET, activation=activation)
    moves, counts = roots.midgame(4, 2**31 + 97, "cpu", max_moves=40)
    _, planes = _planes(moves, counts)
    w = N.make_weights(net, 3, "cpu")
    out = program.net(net, w, "cpu")(planes)
    logits, wdl = N.forward(net, w, planes)
    assert torch.allclose(out["wdl"], wdl, atol=1e-5)
    assert torch.allclose(out["prob"], logits, atol=1e-4)


def test_seeds_permute_one_net():
    """Two seeds' weights differ and compute the same function."""
    from port_bench import weights

    moves, counts = roots.midgame(4, 2**31 + 96, "cpu", max_moves=40)
    _, planes = _planes(moves, counts)
    a, b = weights.make(NET, 2**31 + 1, "cpu"), weights.make(NET, 2**31 + 2, "cpu")
    assert not torch.equal(a["tower.0.conv1.conv.weight"], b["tower.0.conv1.conv.weight"])
    la, wa = N.forward(NET, a, planes)
    lb, wb = N.forward(NET, b, planes)
    assert torch.allclose(la, lb, atol=1e-4) and torch.allclose(wa, wb, atol=1e-5)
