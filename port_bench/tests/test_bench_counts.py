"""The operation and byte counts the mfu and roofline readers divide by,
against a count by hand and against PyTorch's FlopCounterMode on the
measured program's forward, for every block family and policy head; and
the weights of the benchmark's configurations, pinned bit for bit."""

import hashlib
import json

import pytest
import torch
from conftest import EVERY_FAMILY, ROOT
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


def _one_block(spec, c, **kw):
    """(operations, bytes at `rows`) that one block `spec` adds to a net
    of `c` channels."""
    base = dict(_net("b15c192"), residual_channels=c, **kw)
    with_block, without = dict(base, stack=[spec]), dict(base, stack=[])
    return (peaks.forward_flops(with_block) - peaks.forward_flops(without),
            peaks.forward_bytes(with_block, 256) - peaks.forward_bytes(without, 256))


def test_nested_bottleneck_384_192_by_hand():
    """1x1 384 -> 192, four 3x3 convs at 192, 1x1 192 -> 384: 1.0646
    GFLOP, where two 3x3 convs of 384 would count 1.9163."""
    hw, c, h = 361, 384, 192
    flops, nbytes = _one_block("NestedBottleneckBlock", c)
    assert flops == 2 * hw * (c * h + 4 * 9 * h * h + h * c) == 1_064_632_320
    weights = c * h + 4 * 9 * h * h + h * c
    acts = hw * ((c + h) + 4 * 2 * h + (h + c))
    assert nbytes == 2 * weights + 256 * 2 * acts


def test_mixer_block_by_hand():
    """A 7x7 depthwise conv over c (49 weights a channel, HW * 2c
    activations), then the 1x1 FFN c -> 1.5c -> c."""
    hw, c = 361, 96
    f = int(1.5 * c)
    flops, nbytes = _one_block("MixerBlockV2", c)
    assert flops == 2 * hw * (49 * c + c * f + f * c)
    assert nbytes == 2 * (49 * c + 2 * c * f) + 256 * 2 * hw * (2 * c + (c + f) + (f + c))


def test_replk_head_by_hand():
    """The RepLK head adds a max(kernel, 7) depthwise conv and a 1x1 conv
    of its channels."""
    hw, p = 361, 24
    normal = peaks.forward_flops(_net("b6c96"))
    for kernel, k in ((None, 7), (5, 7), (9, 9)):
        extra = {} if kernel is None else {"policy_head_kernel": kernel}
        replk = peaks.forward_flops(dict(_net("b6c96"), policy_head_type="RepLK", **extra))
        assert replk - normal == 2 * hw * (k * k * p + p * p)


TEST_NETS = {"residual": {}, "every-family": {"stack": EVERY_FAMILY}}


@pytest.mark.parametrize("head", ["Normal", "RepLK"])
@pytest.mark.parametrize("arch", sorted(TEST_NETS))
def test_forward_flops_is_the_flop_counters(arch, head):
    """FlopCounterMode over the program's eval forward on one position
    counts each convolution as 2 * out cells * k^2 * C_in / groups * C_out
    and each dense layer as 2 * in * out, biases and elementwise work not
    counted, as peaks does; the depthwise blocks run one merged k x k
    kernel, which is what peaks counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench import program
    from port_bench.reference import net as N

    net = dict(_net("b6c96"), residual_channels=16, policy_head_channels=8,
               value_head_channels=8, policy_head_type=head, **TEST_NETS[arch])
    model = program.net(net, N.make_weights(net, 5, "cpu"), "cpu")
    planes = torch.ones(1, 19, 19, net["input_channels"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(planes)
    assert counter.get_total_flops() == peaks.forward_flops(net)


# sha256 of weights.make(config, PIN_SEED, "cpu"): every name, then its
# float32 bytes, in the dict's order (recorded before the harness knew any
# family but the residual block)
PIN_SEED = 2**31 + 11
PINS = {"b6c96": "d21a69fddf299a054b42904ed781134c235d19a3d8f85ec1c3bc032b3b0caa89",
        "b15c192": "72b8071f46b38ec7243fcf0c1f418c1f0290499feb82468d7bfb870b87a06a91"}


@pytest.mark.parametrize("config", sorted(PINS))
def test_configuration_weights_are_pinned(config):
    from port_bench import weights

    digest = hashlib.sha256()
    for name, value in weights.make(_net(config), PIN_SEED, "cpu").items():
        digest.update(name.encode())
        digest.update(value.contiguous().numpy().tobytes())
    assert digest.hexdigest() == PINS[config]
