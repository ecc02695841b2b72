"""The net's eval forward (models/network.py ``_forward_eval``) and the
plain twin of its epilogue (ops/epilogue.py ``epilogue_plain``) on the CPU:

- the twin equals, bit for bit in float32, the module math it replaces: an
  eval ConvBlock (with and without gamma), a block tail with and without
  SE (``_Block._finish``, ``SqueezeExcite``) and the MixerBlock's skip
  after the activation, for every activation, on 9x9 boards inside a 19x19
  buffer;
- the eval forward equals the modules' forward (``forward_modules``) bit
  for bit, for a net of each block family and the RepLK head, in float32
  and under bf16 autocast;
- the inference cache refolds after ``load_state_dict`` and an in-place
  ``copy_`` and counts it (``net_weight_refolds``), and not otherwise;
- ``train()`` takes neither the cache nor the epilogue and still updates
  the running statistics; an eval forward with autograd on takes the
  modules' forward, builds no cache and passes gradients;
- the recorder counts the conv blocks of an eval forward;
- the kernel wrapper's argument checks.

The kernel itself runs on the CPU in tests/test_torch_kernel_shim.py and on
the card in tests/test_torch_cuda.py.
"""

import pytest
import torch

from sayuri_tpu_torch import telemetry as T
from sayuri_tpu_torch.models import network as N
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.ops import epilogue as EP
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

C = 16
# every block family once, and the RepLK head
FAMILIES = ("ResidualBlock", "ResidualBlock-SE", "BottleneckBlock-SE",
            "NestedBottleneckBlock-SE", "MixerBlock", "MixerBlockV2-SE", "RepLK")
# conv blocks of `mixed_net` with the RepLK head: input 1, bottleneck 4,
# nested 1 + 2 x 2 + 1, mixer 3, mixer V2 3, residual 2, heads 4
MIXED_BLOCKS = 1 + 4 + 6 + 3 + 3 + 2 + 4


def board_mask(b=3, n=19, sizes=(9, 7, 5)):
    """[b, n, n] float32: boards of `sizes` in the top-left of the buffer."""
    m = torch.zeros(b, n, n)
    for i, s in enumerate(sizes[:b]):
        m[i, :s, :s] = 1.0
    return m


def planes(b=3, n=9, seed=1):
    g = torch.Generator().manual_seed(seed)
    m = board_mask(b, n, (n, n - 2, n - 4))
    p = (torch.rand(b, n, n, 43, generator=g) > 0.6).float() * m[..., None]
    p[..., 38:42] = torch.randn(b, 1, 1, 4, generator=g) * m[..., None]
    p[..., 42] = m
    return p


def randomize(module, seed=0):
    """Seeded weights, and biases, betas, gammas and running statistics
    away from their zeros and ones, so that no fold hides behind them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*module.named_parameters(), *module.named_buffers()]:
            if name.endswith("var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith("bn.gamma"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("mean", "beta", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5)
    return module


def mixed_net(act="mish", n=9):
    cfg = NetConfig(boardsize=n, residual_channels=C, policy_head_channels=8,
                    value_head_channels=8, activation=act, policy_head_type="RepLK",
                    stack=("BottleneckBlock-SE", "NestedBottleneckBlock", "MixerBlock",
                           "MixerBlockV2-SE", "ResidualBlock"))
    return randomize(SayuriNet(cfg)).eval()


def family_net(family, act="mish"):
    head = "RepLK" if family == "RepLK" else "Normal"
    stack = ("ResidualBlock",) if family == "RepLK" else (family,)
    cfg = NetConfig(boardsize=9, residual_channels=C, policy_head_channels=8,
                    value_head_channels=8, activation=act, policy_head_type=head,
                    stack=stack)
    return randomize(SayuriNet(cfg)).eval()


def nchw(t):
    return t.permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


VARIANTS = ("conv", "conv-gamma", "tail", "tail-se", "mixer-skip")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("act", EP.ACTS)
def test_twin_equals_module_math(act, variant):
    """The twin against the eval modules, in float32, on conv outputs of
    9x9, 7x7 and 5x5 boards inside a 19x19 buffer."""
    g = torch.Generator().manual_seed(EP.ACTS.index(act))
    m = board_mask()
    mask = m[:, None]
    msum = mask.sum((1, 2, 3))
    msqrt = torch.sqrt(msum)
    # a conv's output and the block's input, channels-last as in the net
    y = nchw(torch.randn(3, 19, 19, C, generator=g))
    skip = nchw(torch.randn(3, 19, 19, C, generator=g) * m[..., None])
    with torch.no_grad():
        if variant.startswith("conv"):
            cb = randomize(N.ConvBlock(C, C, 3, variant == "conv-gamma", act)).eval()
            want = cb.act(cb.bn(y * mask, mask))
            got, _ = EP.epilogue_plain(nhwc(y), m, *cb.bn.folded(), act=act)
        elif variant.startswith("tail"):
            blk = randomize(N.ResidualBlock(C, 4 if variant == "tail-se" else None,
                                            act)).eval()
            cb = blk.conv2
            out = cb.act(cb.bn(y * mask, mask))
            want = blk._finish(out, skip, mask, msum, msqrt)
            if blk.se is None:
                got, _ = EP.epilogue_plain(nhwc(y), m, *cb.bn.folded(), skip=nhwc(skip),
                                           act=act)
            else:
                bn, _ = EP.epilogue_plain(nhwc(y), m, *cb.bn.folded())
                assert torch.equal(nchw(bn), out)
                se = blk.se.excite(blk.se.squeeze(N.global_pool(out, mask, msum, msqrt)))
                got, _ = EP.epilogue_plain(bn, m, se=se, skip=nhwc(skip), act=act)
        else:
            dw = randomize(N.DepthwiseConvBlock(C, 7, True, act)).eval()
            want = dw.act(dw.bn(y * mask, mask)) + skip
            got, _ = EP.epilogue_plain(nhwc(y), m, *dw.bn.folded(), skip=nhwc(skip),
                                       skip_after_act=True, act=act)
    assert torch.equal(nchw(got), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_eval_forward_equals_module_forward(family, dtype):
    net = family_net(family)
    x = planes()
    with torch.no_grad(), torch.autocast("cpu", dtype=dtype,
                                         enabled=dtype != torch.float32):
        want = net.forward_modules(x)
        got = net(x)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _refolds(net, x):
    with T.run(1) as rec, torch.no_grad():
        net(x)
    return rec.counter("net_weight_refolds")


@pytest.mark.parametrize("change", ["load_state_dict", "copy_"])
def test_cache_refolds_after_weight_change(change):
    net = mixed_net()
    x = planes()
    n_cached = _refolds(net, x)
    # every conv block, the two plain head convs and the dense layers
    assert n_cached == MIXED_BLOCKS + 2 + 4 + 4
    assert _refolds(net, x) == 0
    other = randomize(mixed_net(), seed=7)
    with torch.no_grad():
        if change == "load_state_dict":
            net.load_state_dict(other.state_dict())
            expect = n_cached
        else:
            net.tower[0].conv1.bn.var.copy_(other.tower[0].conv1.bn.var)
            net.pol_misc.weight.copy_(other.pol_misc.weight)
            expect = 2
        want = other.forward_modules(x) if change == "load_state_dict" else None
    assert _refolds(net, x) == expect
    assert _refolds(net, x) == 0
    with torch.no_grad():
        got, ref = net(x), net.forward_modules(x)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        if want is not None:
            assert torch.equal(got[k], want[k]), k


def test_train_mode_takes_neither_the_cache_nor_the_epilogue(monkeypatch):
    net = mixed_net()
    net.train()

    def refuse(*a, **kw):
        raise AssertionError("the epilogue ran in train()")

    monkeypatch.setattr(EP, "epilogue", refuse)
    monkeypatch.setattr(EP, "epilogue_plain", refuse)
    bn = net.tower[0].pre.bn
    before = bn.mean.clone(), bn.var.clone()
    out = net(planes())
    out["prob"].sum().backward()
    assert not any("_inference_cache" in m.__dict__ for m in net.modules())
    assert not torch.equal(bn.mean, before[0]) and not torch.equal(bn.var, before[1])
    assert net.tower[0].pre.conv.weight.grad is not None


def test_eval_with_autograd_derives_weights_afresh():
    net = mixed_net()
    x = planes()
    out = net(x)
    assert not any("_inference_cache" in m.__dict__ for m in net.modules())
    (out["wdl"].sum() + out["prob"].sum()).backward()
    assert net.tower[2].dw.conv.gamma.grad is not None
    assert net.policy_dw.bn.beta.grad is not None
    with torch.no_grad():
        ref = net.forward_modules(x)
    for k in ref:
        assert torch.equal(out[k].detach(), ref[k]), k


def test_recorder_counts_the_conv_blocks():
    net = mixed_net()
    with T.run(1) as rec, torch.no_grad():
        net(planes())
        net(planes())
    assert rec.counter("net_conv_blocks") == 2 * MIXED_BLOCKS
    # the CPU takes the twin, never the kernel
    assert rec.counter("net_epilogues_fused") == 0


def test_launch_args_checks_its_inputs():
    # the kernel's activation ids name every activation of the net
    assert set(EP.ACTS) == set(N._ACTS)
    x = torch.zeros(2, 5, 5, C, dtype=torch.bfloat16)
    m = torch.ones(2, 5, 5)
    sc = torch.ones(C)
    args, y32, ylo = EP.launch_args(x, m, sc, sc, skip=torch.zeros(2, 5, 5, C),
                                       act="mish", out_lo=torch.bfloat16)
    assert y32.dtype == torch.float32 and ylo.dtype == torch.bfloat16
    assert args[8] == 1 and args[9] == EP.ACTS.index("mish") and args[15]
    with pytest.raises(ValueError, match="scale and bias"):
        EP.launch_args(x, m, sc)
    with pytest.raises(TypeError, match="dtype"):
        EP.launch_args(x, m.double())
    with pytest.raises(ValueError, match="shape"):
        EP.launch_args(x, m, torch.ones(C + 1), torch.ones(C + 1))
    with pytest.raises(ValueError, match="contiguous"):
        EP.launch_args(x.transpose(1, 2), m)
    with pytest.raises(ValueError, match="act"):
        EP.launch_args(x, m, act="tanh")
    with pytest.raises(TypeError, match="out_lo"):
        EP.launch_args(x, m, out_lo=torch.float16)
    # 12 channels take one channel a thread
    x12 = torch.zeros(2, 5, 5, 12)
    assert not EP.launch_args(x12, m)[0][15]
