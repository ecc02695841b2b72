"""The plain reference: its encoder commutes with the board's symmetries,
its evaluation under a symmetry is the evaluation of the transformed
position, and in float32 on the CPU its net gives the measured program's
outputs on the same weights, for every block family with either policy
head; two seeds' weights compute one function."""

import pytest
import torch
from conftest import EVERY_FAMILY

from port_bench import roots
from port_bench.reference import check as RC
from port_bench.reference import frozen as R
from port_bench.reference import net as N
from port_bench.reference import rules as RU

NET = {"boardsize": 19, "input_channels": 43, "residual_channels": 16,
       "stack": ["ResidualBlock", "ResidualBlock-SE"], "se_ratio": 4,
       "policy_head_channels": 8, "value_head_channels": 8, "policy_head_type": "Normal",
       "activation": "relu", "policy_outs": 5, "value_misc": 15}
# the residual net, and a stack of every family under each policy head
NETS = {"residual": NET,
        "every-family": dict(NET, stack=EVERY_FAMILY),
        "every-family-replk": dict(NET, stack=EVERY_FAMILY, policy_head_type="RepLK",
                                   policy_head_kernel=9)}


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


# specs whose parts name more than one block, as the program's parse reads them
MIXED_SPECS = ["MixerBlockV2-MixerBlock", "MixerBlock-MixerBlockV2", "MixerBlockV1-MixerBlockV2-SE",
               "SE-MixerBlockV1", "MixerBlockV2-ResidualBlock", "ResidualBlock-MixerBlock",
               "BottleneckBlock-NestedBottleneckBlock-SE", "NestedBottleneckBlock-BottleneckBlock"]
PROGRAM_FAMILIES = {"ResidualBlock": "residual", "BottleneckBlock": "bottleneck",
                    "NestedBottleneckBlock": "nested", "MixerBlock": "mixer"}


def test_blocks_are_parsed_as_the_program_builds_them():
    from port_bench import program

    net = dict(NET, stack=MIXED_SPECS)
    built = program.net(net, N.make_weights(net, 3, "cpu"), "cpu")
    assert N.blocks(net) == [(PROGRAM_FAMILIES[type(b).__name__], getattr(b, "version", 0),
                              b.se is not None) for b in built.tower]


@pytest.mark.parametrize("arch", sorted(NETS))
@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_reference_net_is_the_programs_in_float32(activation, arch):
    from port_bench import program

    net = dict(NETS[arch], activation=activation)
    moves, counts = roots.midgame(4, 2**31 + 97, "cpu", max_moves=40)
    _, planes = _planes(moves, counts)
    w = N.make_weights(net, 3, "cpu")
    out = program.net(net, w, "cpu")(planes)
    logits, wdl = N.forward(net, w, planes)
    assert torch.allclose(out["wdl"], wdl, atol=1e-5)
    assert torch.allclose(out["prob"], logits, atol=1e-4)


@pytest.mark.parametrize("arch", sorted(NETS))
def test_seeds_permute_one_net(arch):
    """Two seeds' weights differ in an inner width of every block and
    compute the same function."""
    from port_bench import weights

    net = NETS[arch]
    moves, counts = roots.midgame(4, 2**31 + 96, "cpu", max_moves=40)
    _, planes = _planes(moves, counts)
    a, b = weights.make(net, 2**31 + 1, "cpu"), weights.make(net, 2**31 + 2, "cpu")
    for i, (kind, _, _) in enumerate(N.blocks(net)):
        for src, dst in weights.INNER[kind]:
            for name in (f"tower.{i}.{src}.conv.weight", f"tower.{i}.{dst}.conv.weight"):
                assert not torch.equal(a[name], b[name]), name
    la, wa = N.forward(net, a, planes)
    lb, wb = N.forward(net, b, planes)
    assert torch.allclose(la, lb, atol=1e-4) and torch.allclose(wa, wb, atol=1e-5)
