"""Masked policy/value ResNet as a PyTorch ``nn.Module`` (port of
sayuri_tpu.models.network).

- every conv output is multiplied by the on-board mask (mixed board sizes
  share one fixed buffer);
- BatchNorm in ``eval()`` runs in inference form: the running statistics
  folded into one per-channel multiply-add, then the mask; in ``train()``
  it is masked batch renorm (statistics over on-board cells only, r and d
  clipped by ``renorm_max_r`` / ``renorm_max_d``, running statistics
  updated with momentum 0.01 * sqrt(B / 256));
- the error head's softplus has KataGo's gradient floor;
- GlobalPool = concat(mean, mean*(sqrt(hw)-14)/10, max) for the policy
  head and SE, with the board-size polynomial variant for the value head;
- blocks: ResidualBlock, BottleneckBlock, NestedBottleneckBlock and
  MixerBlock (V1 / V2: a large-kernel depthwise conv and a 1x1 FFN), each
  with optional SE;
- the policy head ("Normal", or "RepLK" with a large-kernel depthwise conv
  and a pointwise conv before it) emits 5 spatial policy planes + 5 pass
  logits; the value head emits 15 values = wdl(3) + q_vals(5) + scores(5) +
  errors(2), plus tanh ownership.

Convolutions run through cuDNN (``F.conv2d``, grouped for the depthwise
ones); the public call takes NHWC planes like the JAX package. For bf16,
wrap the call in ``torch.autocast``.

Two forwards share the modules:
- ``train()``: each module's ``forward`` (NCHW views of the planes), the
  batch norm as masked batch renorm;
- ``eval()``: ``infer`` on NHWC tensors end to end. The weights come from
  an inference cache on each module (each conv weight in the compute dtype
  and channels-last, the depthwise blocks' merged kernel, the batch norms'
  folded float32 scale and bias, the dense layers' weights), rebuilt when a
  parameter or buffer is replaced or changed in place (its data_ptr or
  _version). After each conv one epilogue (``ops/epilogue.py``) applies the
  mask, the folded batch norm, the SE scale, the skip and the activation in
  float32, and writes the float32 residual stream and the compute-dtype
  copy the next conv reads, in one pass: csrc/epilogue.cu's kernel on
  CUDA, the same formulas in PyTorch on the CPU. It runs with autograd
  off; a forward with autograd on, in eval() too, takes the modules'
  forward (``forward_modules``), the one that passes gradients. The
  recorder counts the conv blocks of eval forwards (``net_conv_blocks``),
  those whose epilogue took the kernel (``net_epilogues_fused``) and the
  cache's rebuilds (``net_weight_refolds``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sayuri_tpu_torch import telemetry as T
from sayuri_tpu_torch.ops import epilogue as E

CRAZY_NEGATIVE_VALUE = -5000.0
B_AVG = (19 + 9) / 2
B_VARIANCE = 0.1
# running statistics' momentum, scaled by sqrt(batch / BN_BASIC_BATCH)
BN_MOMENTUM = 0.01
BN_BASIC_BATCH = 256


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Static architecture config (defaults: the b6c96 RL net)."""

    boardsize: int = 19
    input_channels: int = 43
    residual_channels: int = 96
    stack: Sequence[str] = (
        "ResidualBlock",
        "ResidualBlock",
        "ResidualBlock-SE",
        "ResidualBlock",
        "ResidualBlock",
        "ResidualBlock-SE",
    )
    se_ratio: int = 4
    policy_head_channels: int = 32
    value_head_channels: int = 32
    policy_head_type: str = "Normal"  # or "RepLK"
    policy_head_kernel: int = 7
    activation: str = "relu"
    renorm_max_r: float = 1.0
    renorm_max_d: float = 0.0
    value_misc: int = 15
    policy_outs: int = 5


_ACTS = E.ACT_FNS


def act_fn(name: str):
    return _ACTS[name]


def _state_slots(module):
    """(dict, name) of every parameter and buffer of `module` and its
    submodules, listed once: the cache key reads the tensors through them,
    so that a replaced tensor is seen."""
    slots = module.__dict__.get("_state_slots")
    if slots is None:
        mods = list(module.modules())
        slots = [(m._parameters, n) for m in mods for n in m._parameters] + \
                [(m._buffers, n) for m in mods for n in m._buffers]
        module.__dict__["_state_slots"] = slots
    return slots


def _inference_cache(module, dtype, device, build):
    """`build(dtype)`'s tensors, kept on `module` until one of its
    parameters or buffers is replaced or changed in place (a load_state_dict,
    a copy_, an optimizer step: their data_ptr or _version), or another
    dtype or device asks. A rebuild counts as `net_weight_refolds`."""
    key = (dtype, device, tuple((t.data_ptr(), t._version) for d, n in _state_slots(module)
                                if (t := d[n]) is not None))
    entry = module.__dict__.get("_inference_cache")
    if entry is not None and entry[0] == key:
        return entry[1]
    with torch.no_grad():
        value = build(dtype)
    module.__dict__["_inference_cache"] = (key, value)
    T.count("net_weight_refolds")
    return value


def _channels_last(w, dtype):
    return w.to(dtype).contiguous(memory_format=torch.channels_last)


def _conv_nhwc(x, w, b, padding, groups=1):
    """F.conv2d on NHWC `x` [B, H, W, Cin] with a channels-last weight:
    cuDNN reads and writes NHWC, and the result is NHWC again."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=padding,
                    groups=groups).permute(0, 2, 3, 1)


class _Eval:
    """One eval forward's shared state: the board mask [B, H, W] (float32,
    contiguous) and its views, the compute dtype (autocast's, else float32),
    whether the epilogue takes the kernel (on CUDA) and the conv blocks
    counted for the recorder."""

    def __init__(self, planes, mask_plane):
        dev = planes.device
        self.device = dev
        self.dtype = (torch.get_autocast_dtype(dev.type)
                      if torch.is_autocast_enabled(dev.type) else torch.float32)
        self.fused = dev.type == "cuda"
        self.m = planes[..., mask_plane].float().contiguous()
        self.mask = self.m[:, None]            # [B, 1, H, W], for global_pool
        self.m4 = self.m[..., None]            # [B, H, W, 1]
        self.msum = self.m.sum((1, 2))
        self.msqrt = torch.sqrt(self.msum)
        self.factors = pool_factors(self.mask, self.msum, self.msqrt)
        self.neg = self.factors[3][:, 0]       # [B, H, W]
        self.blocks = self.fused_blocks = 0

    def weights(self, module, build):
        """`build(dtype)`, from `module`'s inference cache."""
        return _inference_cache(module, self.dtype, self.device, build)

    def conv(self, module, x):
        """A plain nn.Conv2d (with bias) on NHWC `x`, its weight cached."""
        w, b = self.weights(module, lambda dt: (_channels_last(module.weight, dt),
                                                module.bias.to(dt)))
        return _conv_nhwc(x, w, b, module.padding[0])

    def pool(self, x, is_value_head=False):
        """global_pool of NHWC `x`."""
        return global_pool(x.permute(0, 3, 1, 2), self.mask, self.msum, self.msqrt,
                           is_value_head, self.factors)

    def epilogue(self, x, scale=None, bias=None, *, want, **kw):
        """ops/epilogue.py on `x` -> (float32 y, y in the compute dtype):
        `want` "f32", "lo" or "both" says which the caller reads (in
        float32 compute one tensor is both)."""
        f, lo = E.epilogue(x, self.m, scale, bias, out_f32=want != "lo",
                   out_lo=None if want == "f32" else self.dtype, **kw)
        if self.dtype == torch.float32:
            f = lo = f if f is not None else lo
        return f, lo

    def block(self, x, scale, bias, want, act, **kw):
        """A conv block's epilogue, counted."""
        self.blocks += 1
        self.fused_blocks += self.fused
        return self.epilogue(x, scale, bias, want=want, act=act, **kw)

    def record(self):
        T.count("net_conv_blocks", self.blocks)
        T.count("net_epilogues_fused", self.fused_blocks)


class _SoftplusGradientFloor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.square(F.softplus(0.5 * x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (0.05 + 0.95 * torch.sigmoid(x))


def softplus_with_gradient_floor(x):
    """KataGo's SoftPlusWithGradientFloor, squared variant: forward
    softplus(x / 2)^2; backward g * (0.05 + 0.95 * sigmoid(x)), which is not
    the forward's derivative: the gradient never falls below 0.05."""
    return _SoftplusGradientFloor.apply(x)


class MaskedBatchNorm(nn.Module):
    """Masked batch norm. Inference (``eval()``): x * rsqrt(var + eps) *
    gamma + (beta - mean * scale), then times the mask. Training: masked
    batch renorm, r in [1/rmax, rmax] and d in [-dmax, dmax] (rmax=1, dmax=0
    is plain masked batch norm); with ``sync`` set to a mesh, over the
    global batch of every rank, as the JAX step computes it under a mesh."""

    def __init__(self, features: int, use_gamma: bool, eps: float = 1e-5,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        # a parallel.mesh.Mesh: training statistics over every rank's batch
        self.sync = None
        self.eps = eps
        self.rmax, self.dmax = rmax, dmax
        self.beta = nn.Parameter(torch.zeros(features))
        self.gamma = nn.Parameter(torch.ones(features)) if use_gamma else None
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, mask):
        if self.training:
            return self._renorm(x, mask)
        scale, bias = self.folded()
        out = x * scale[None, :, None, None] + bias[None, :, None, None]
        return out * mask

    def folded(self):
        """The inference form's float32 (scale, bias): rsqrt(var + eps) *
        gamma and beta - mean * scale."""
        scale = torch.rsqrt(self.var + self.eps)
        if self.gamma is not None:
            scale = scale * self.gamma
        return scale, self.beta - self.mean * scale

    def _renorm(self, x, mask):
        xf = x.float()
        # the divisor counts on-board cells only, not B * H * W
        mask_sum = mask.float().sum()
        total = xf.sum((0, 2, 3))
        batch = x.shape[0]
        if self.sync is not None:
            # the global batch's sums: one all-reduce for the sums and the
            # count, one for the centred squares, each summed back over the
            # ranks in the backward
            both = self.sync.all_reduce_sum(torch.cat([total, mask_sum[None]]))
            total, mask_sum = both[:-1], both[-1]
            batch *= self.sync.size
        mean = total / mask_sum
        zm = (xf - mean[:, None, None]) * mask
        sq = torch.square(zm).sum((0, 2, 3))
        if self.sync is not None:
            sq = self.sync.all_reduce_sum(sq)
        var = sq / mask_sum
        std = torch.sqrt(var + self.eps)
        r_std = torch.sqrt(self.var + self.eps)
        r = torch.clamp(std.detach() / r_std, 1.0 / self.rmax, self.rmax)
        d = torch.clamp((mean.detach() - self.mean) / r_std, -self.dmax, self.dmax)
        out = (xf - mean[:, None, None]) / std[:, None, None] * r[:, None, None] \
            + d[:, None, None]
        m = BN_MOMENTUM * math.sqrt(batch / BN_BASIC_BATCH)
        with torch.no_grad():
            self.mean.add_(m * (mean - self.mean))
            self.var.add_(m * (var - self.var))
        if self.gamma is not None:
            out = out * self.gamma[:, None, None]
        out = out + self.beta[:, None, None]
        return (out * mask).to(x.dtype)


class ConvBlock(nn.Module):
    """conv (no bias) -> *mask -> BN -> act."""

    def __init__(self, cin: int, cout: int, kernel: int, use_gamma: bool,
                 activation: str, rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False)
        self.bn = MaskedBatchNorm(cout, use_gamma, rmax=rmax, dmax=dmax)
        self.act_name = activation
        self.act = act_fn(activation)

    def forward(self, x, mask):
        return self.act(self.bn(self.conv(x) * mask, mask))

    def _folded(self, dtype):
        return (_channels_last(self.conv.weight, dtype), *self.bn.folded())

    def infer(self, ev, x, want, act=None, **tail):
        """Eval: NHWC `x` in the compute dtype -> (float32, compute dtype)
        outputs (``_Eval.epilogue``); `act` (default the block's own) and
        `tail` (se, skip, skip_after_act) go to the epilogue."""
        w, scale, bias = ev.weights(self, self._folded)
        y = _conv_nhwc(x, w, None, self.conv.padding[0])
        return ev.block(y, scale, bias, want, act or self.act_name, **tail)


class BroadcastDWConv(nn.Module):
    """Depthwise conv whose effective kernel adds a gamma-weighted sum over
    the channels to every channel's kernel: w + sum_c(w_c * gamma_c),
    recomputed each call. ``weight`` is [C, 1, k, k] (F.conv2d's depthwise
    layout); ``gamma`` starts at 1/sqrt(C), ``bias`` at zero."""

    def __init__(self, features: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, 1, kernel, kernel))
        self.gamma = nn.Parameter(torch.full((features,), 1.0 / math.sqrt(features)))
        self.bias = nn.Parameter(torch.zeros(features))

    def effective_weight(self):
        w = self.weight
        return w + (w * self.gamma[:, None, None, None]).sum(0, keepdim=True)


class DepthwiseConvBlock(nn.Module):
    """(k x k depthwise conv + 3x3 reparam depthwise conv, each with its bias)
    -> *mask -> BN -> act. Both convs pad SAME, so they run as one grouped
    conv: the 3x3 effective kernel zero-padded into the k x k one, the
    biases summed (the merged form the v5 file stores)."""

    def __init__(self, features: int, kernel: int, use_gamma: bool, activation: str,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        if kernel < 3 or kernel % 2 == 0:
            raise ValueError(f"depthwise kernel {kernel}: needs an odd size of 3 or more")
        self.conv = BroadcastDWConv(features, kernel)
        self.rep3x3 = BroadcastDWConv(features, 3)
        self.bn = MaskedBatchNorm(features, use_gamma, rmax=rmax, dmax=dmax)
        self.act_name = activation
        self.act = act_fn(activation)

    def merged(self):
        """The merged float32 kernel [C, 1, k, k] and bias [C]."""
        k = self.conv.weight.shape[-1]
        p = (k - 3) // 2
        w = self.conv.effective_weight() + F.pad(self.rep3x3.effective_weight(), (p, p, p, p))
        return w, self.conv.bias + self.rep3x3.bias

    def conv2d(self, x, w=None, b=None):
        """The grouped conv of NCHW `x`, with the merged kernel `w` and bias
        `b` (default: merged now)."""
        if w is None:
            w, b = self.merged()
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2, groups=w.shape[0])

    def forward(self, x, mask):
        return self.act(self.bn(self.conv2d(x) * mask, mask))

    def _folded(self, dtype):
        w, b = self.merged()
        return (_channels_last(w, dtype), b.to(dtype), *self.bn.folded())

    def infer(self, ev, x, want, **tail):
        """As ConvBlock.infer."""
        w, b, scale, bias = ev.weights(self, self._folded)
        y = self.conv2d(x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)
        return ev.block(y, scale, bias, want, self.act_name, **tail)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, activation: str = "identity"):
        super().__init__()
        self.fc = nn.Linear(cin, cout)
        self.act = act_fn(activation)

    def forward(self, x):
        return self.act(self.fc(x))

    def infer(self, ev, x):
        w, b = ev.weights(self, lambda dt: (self.fc.weight.to(dt), self.fc.bias.to(dt)))
        return self.act(F.linear(x, w, b))


def pool_factors(mask, msum, msqrt, is_value_head=None):
    """global_pool's per-board factors: (divisor [B, 1], the l1 factor
    [B, 1], the value head's l2 factor [B, 1], the off-board penalty
    (1 - mask) * CRAZY_NEGATIVE_VALUE); True or False for `is_value_head`
    leaves out (None) the factor only the other head reads."""
    b_diff = msqrt[:, None] - B_AVG
    f2 = torch.square(b_diff) / 100.0 - B_VARIANCE if is_value_head is not False else None
    neg = (1.0 - mask.float()) * CRAZY_NEGATIVE_VALUE if not is_value_head else None
    return msum[:, None], b_diff / 10.0, f2, neg


def global_pool(x, mask, msum, msqrt, is_value_head=False, factors=None):
    """[B, C, H, W] -> [B, 3C]; `factors`: pool_factors(mask, msum, msqrt)
    when the caller has them."""
    div, f1, f2, neg = factors or pool_factors(mask, msum, msqrt, is_value_head)
    xf = x.float()
    mean = xf.sum((2, 3)) / div
    l2 = mean * f2 if is_value_head else (xf + neg).amax((2, 3))
    return torch.cat([mean, mean * f1, l2], 1).to(x.dtype)


class SqueezeExcite(nn.Module):
    """gpool -> squeeze FC -> excite FC -> sigmoid scale + bias."""

    def __init__(self, features: int, se_size: int, activation: str):
        super().__init__()
        self.squeeze = Dense(3 * features, se_size, activation)
        self.excite = Dense(se_size, 2 * features)

    def forward(self, x, mask, msum, msqrt):
        s = self.excite(self.squeeze(global_pool(x, mask, msum, msqrt)))
        gammas, betas = s.chunk(2, dim=1)
        out = torch.sigmoid(gammas)[:, :, None, None] * x + betas[:, :, None, None]
        return out * mask

    def gates(self, ev, x):
        """Eval: the excite layer's output [B, 2C] (gammas | betas) for NHWC
        `x`; the epilogue applies them."""
        return self.excite.infer(ev, self.squeeze.infer(ev, ev.pool(x)))


class _Block(nn.Module):
    """A tower block's tail: the optional SE (``self.se``), then
    act(out + skip) (``self.act``)."""

    def _finish(self, out, skip, mask, msum, msqrt):
        if self.se is not None:
            out = self.se(out, mask, msum, msqrt)
        return self.act(out + skip)

    def _finish_infer(self, ev, conv, x, skip, want):
        """Eval: the tail conv `conv` (its activation the identity) on `x`,
        then the tail, in the conv's epilogue; with SE, the conv's epilogue
        writes the float32 output that the SE pools, and a second epilogue
        applies the gates, the skip and the activation."""
        if self.se is None:
            return conv.infer(ev, x, want, act=self.act_name, skip=skip)
        y, _ = conv.infer(ev, x, "f32")
        return ev.epilogue(y, se=self.se.gates(ev, y), skip=skip, act=self.act_name,
                           want=want)


def _se(features: int, se_size: int | None, activation: str):
    return SqueezeExcite(features, se_size, activation) if se_size else None


class ResidualBlock(_Block):
    def __init__(self, features: int, se_size: int | None, activation: str,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        self.conv1 = ConvBlock(features, features, 3, False, activation, rmax, dmax)
        self.conv2 = ConvBlock(features, features, 3, True, "identity", rmax, dmax)
        self.se = _se(features, se_size, activation)
        self.act_name = activation
        self.act = act_fn(activation)

    def forward(self, x, mask, msum, msqrt):
        out = self.conv2(self.conv1(x, mask), mask)
        return self._finish(out, x, mask, msum, msqrt)

    def infer(self, ev, x, want="both"):
        """Eval: `x` = (float32, compute dtype) NHWC -> the same pair."""
        _, out = self.conv1.infer(ev, x[1], "lo")
        return self._finish_infer(ev, self.conv2, out, x[0], want)


class BottleneckBlock(_Block):
    """1x1 down to features // 2 channels, two 3x3 convs there, 1x1 back up."""

    def __init__(self, features: int, se_size: int | None, activation: str,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        a, c, rd = activation, features // 2, (rmax, dmax)
        self.pre = ConvBlock(features, c, 1, False, a, *rd)
        self.conv1 = ConvBlock(c, c, 3, False, a, *rd)
        self.conv2 = ConvBlock(c, c, 3, False, a, *rd)
        self.post = ConvBlock(c, features, 1, True, "identity", *rd)
        self.se = _se(features, se_size, a)
        self.act_name = a
        self.act = act_fn(a)

    def forward(self, x, mask, msum, msqrt):
        out = self.pre(x, mask)
        out = self.conv2(self.conv1(out, mask), mask)
        return self._finish(self.post(out, mask), x, mask, msum, msqrt)

    def infer(self, ev, x, want="both"):
        _, out = self.pre.infer(ev, x[1], "lo")
        _, out = self.conv1.infer(ev, out, "lo")
        _, out = self.conv2.infer(ev, out, "lo")
        return self._finish_infer(ev, self.post, out, x[0], want)


class NestedBottleneckBlock(_Block):
    """1x1 down to features // 2 channels, two residual blocks (no SE) there,
    1x1 back up."""

    def __init__(self, features: int, se_size: int | None, activation: str,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        a, c, rd = activation, features // 2, (rmax, dmax)
        self.pre = ConvBlock(features, c, 1, False, a, *rd)
        self.block1 = ResidualBlock(c, None, a, *rd)
        self.block2 = ResidualBlock(c, None, a, *rd)
        self.post = ConvBlock(c, features, 1, True, "identity", *rd)
        self.se = _se(features, se_size, a)
        self.act_name = a
        self.act = act_fn(a)

    def forward(self, x, mask, msum, msqrt):
        out = self.pre(x, mask)
        out = self.block2(self.block1(out, mask, msum, msqrt), mask, msum, msqrt)
        return self._finish(self.post(out, mask), x, mask, msum, msqrt)

    def infer(self, ev, x, want="both"):
        out = self.pre.infer(ev, x[1], "both")
        _, out = self.block2.infer(ev, self.block1.infer(ev, out), "lo")
        return self._finish_infer(ev, self.post, out, x[0], want)


class MixerBlock(_Block):
    """ConvNeXt-style block: a 7x7 depthwise conv block, then a 1x1 FFN of
    int(1.5 * features) channels. Version 1 adds the depthwise block's input
    to its output before the FFN, and the block's final skip adds that sum;
    version 2 has the block's input as its only skip."""

    def __init__(self, features: int, se_size: int | None, activation: str,
                 version: int = 1, rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        a, ffn, rd = activation, int(1.5 * features), (rmax, dmax)
        self.version = version
        self.dw = DepthwiseConvBlock(features, 7, True, a, *rd)
        self.ffn1 = ConvBlock(features, ffn, 1, False, a, *rd)
        self.ffn2 = ConvBlock(ffn, features, 1, True, "identity", *rd)
        self.se = _se(features, se_size, a)
        self.act_name = a
        self.act = act_fn(a)

    def forward(self, x, mask, msum, msqrt):
        if self.version == 1:
            x = self.dw(x, mask) + x
            out = x
        else:
            out = self.dw(x, mask)
        out = self.ffn2(self.ffn1(out, mask), mask)
        return self._finish(out, x, mask, msum, msqrt)

    def infer(self, ev, x, want="both"):
        if self.version == 1:
            x = self.dw.infer(ev, x[1], "both", skip=x[0], skip_after_act=True)
            out = x[1]
        else:
            _, out = self.dw.infer(ev, x[1], "lo")
        _, out = self.ffn1.infer(ev, out, "lo")
        return self._finish_infer(ev, self.ffn2, out, x[0], want)


def _parse_block(spec: str, cfg: NetConfig):
    """'ResidualBlock-SE', 'MixerBlockV2', ... -> the block module (the JAX
    package's parse: the last basic block named wins, -SE anywhere)."""
    se_size = None
    kind = None
    version = 1
    for p in spec.strip().split("-"):
        if p == "SE":
            se_size = cfg.residual_channels // cfg.se_ratio
        elif p in ("ResidualBlock", "BottleneckBlock", "NestedBottleneckBlock"):
            kind = p
        elif p in ("MixerBlock", "MixerBlockV1"):
            kind = "MixerBlock"
        elif p == "MixerBlockV2":
            kind, version = "MixerBlock", 2
        else:
            raise ValueError(f"unknown block component {p!r}")
    if kind is None:
        raise ValueError(f"no basic block in {spec!r}")
    c = cfg.residual_channels
    common = dict(se_size=se_size, activation=cfg.activation,
                  rmax=cfg.renorm_max_r, dmax=cfg.renorm_max_d)
    if kind == "ResidualBlock":
        return ResidualBlock(c, **common)
    if kind == "BottleneckBlock":
        return BottleneckBlock(c, **common)
    if kind == "NestedBottleneckBlock":
        return NestedBottleneckBlock(c, **common)
    return MixerBlock(c, version=version, **common)


class SayuriNet(nn.Module):
    """Full policy/value network.

    forward(planes [B, H, W, 43]) -> dict of heads:
      prob/aux_prob/soft_prob/soft_aux_prob/optimistic_prob: [B, HW+1] logits
      ownership: [B, HW] tanh
      wdl: [B, 3] logits
      q_vals: [B, 5] tanh
      scores: [B, 5] (scaled x20)
      errors: [B, 2] {q_error x0.25, score_error x150}
    """

    def __init__(self, cfg: NetConfig = NetConfig()):
        super().__init__()
        self.cfg = cfg
        c, pc, vc = (cfg.residual_channels, cfg.policy_head_channels,
                     cfg.value_head_channels)
        a, rd = cfg.activation, (cfg.renorm_max_r, cfg.renorm_max_d)
        self.input_conv = ConvBlock(cfg.input_channels, c, 3, True, a, *rd)
        self.tower = nn.ModuleList(_parse_block(s, cfg) for s in cfg.stack)
        self.policy_conv = ConvBlock(c, pc, 1, False, a, *rd)
        if cfg.policy_head_type == "RepLK":
            self.policy_dw = DepthwiseConvBlock(pc, max(cfg.policy_head_kernel, 7), False,
                                                a, *rd)
            self.policy_pw = ConvBlock(pc, pc, 1, True, a, *rd)
        self.policy_inter = Dense(3 * pc, pc, a)
        self.pol_misc = nn.Conv2d(pc, cfg.policy_outs, 1)
        self.pol_pass = Dense(pc, cfg.policy_outs)
        self.value_conv = ConvBlock(c, vc, 1, False, a, *rd)
        self.value_inter = Dense(3 * vc, 3 * vc, a)
        self.ownership_conv = nn.Conv2d(vc, 1, 1)
        self.value_misc = Dense(3 * vc, cfg.value_misc)

    def init_random(self, seed: int = 0):
        """Seeded random weights: xavier-normal kernels, zero biases, unit
        BN statistics, depthwise gammas at 1/sqrt(C)."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear, BroadcastDWConv)):
                    w = m.weight
                    rf = w[0][0].numel() if w.ndim == 4 else 1
                    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
                    std = math.sqrt(2.0 / (fan_in + fan_out))
                    w.copy_(torch.randn(w.shape, generator=g) * std)
                    if m.bias is not None:
                        m.bias.zero_()
                    if isinstance(m, BroadcastDWConv):
                        m.gamma.fill_(1.0 / math.sqrt(w.shape[0]))
        return self

    def forward(self, planes):
        if self.training or torch.is_grad_enabled():
            return self.forward_modules(planes)
        return self._forward_eval(planes)

    def forward_modules(self, planes):
        """The forward through each module's ``forward`` (NCHW views): the
        training forward, and any forward with autograd on; in eval() mode,
        the inference formulas without the cache or the epilogue."""
        cfg = self.cfg
        b, h, w, _ = planes.shape
        hw = h * w
        x = planes.permute(0, 3, 1, 2)
        mask = x[:, cfg.input_channels - 1 :]
        msum = mask.float().sum((1, 2, 3))
        msqrt = torch.sqrt(msum)

        x = self.input_conv(x, mask)
        for block in self.tower:
            x = block(x, mask, msum, msqrt)

        # ---- policy head ----
        pol = self.policy_conv(x, mask)
        if self.cfg.policy_head_type == "RepLK":
            pol = self.policy_pw(self.policy_dw(pol, mask), mask)
        pol_inter = self.policy_inter(global_pool(pol, mask, msum, msqrt))
        pol = (pol + pol_inter[:, :, None, None]) * mask
        pol_spatial = self.pol_misc(pol)
        pol_spatial = pol_spatial * mask + (1.0 - mask) * CRAZY_NEGATIVE_VALUE
        pol_spatial = pol_spatial.reshape(b, cfg.policy_outs, hw).transpose(1, 2)
        pol_pass = self.pol_pass(pol_inter)

        # ---- value head ----
        val = self.value_conv(x, mask)
        val_inter = self.value_inter(
            global_pool(val, mask, msum, msqrt, is_value_head=True)
        )
        ownership = torch.tanh(
            (self.ownership_conv(val) * mask).reshape(b, hw).float()
        )
        return self._outputs(pol_spatial, pol_pass, ownership, self.value_misc(val_inter))

    def _forward_eval(self, planes):
        """The eval forward with autograd off: NHWC throughout, the
        inference cache's weights, one epilogue after each conv (module
        docstring)."""
        cfg = self.cfg
        b, h, w, _ = planes.shape
        hw = h * w
        ev = _Eval(planes, cfg.input_channels - 1)
        x = self.input_conv.infer(ev, planes.to(ev.dtype), "both")
        last = len(self.tower) - 1
        # the heads read the trunk's output through convs only
        for i, block in enumerate(self.tower):
            x = block.infer(ev, x, "lo" if i == last else "both")

        # ---- policy head ----
        if cfg.policy_head_type == "RepLK":
            _, pol = self.policy_conv.infer(ev, x[1], "lo")
            _, pol = self.policy_dw.infer(ev, pol, "lo")
            pol, _ = self.policy_pw.infer(ev, pol, "f32")
        else:
            pol, _ = self.policy_conv.infer(ev, x[1], "f32")
        pol_inter = self.policy_inter.infer(ev, ev.pool(pol))
        pol = (pol + pol_inter[:, None, None, :]) * ev.m4
        pol_spatial = ev.conv(self.pol_misc, pol.to(ev.dtype))
        pol_spatial = pol_spatial * ev.m4 + ev.neg[..., None]
        pol_spatial = pol_spatial.reshape(b, hw, cfg.policy_outs)
        pol_pass = self.pol_pass.infer(ev, pol_inter)

        # ---- value head ----
        val, val_lo = self.value_conv.infer(ev, x[1], "both")
        val_inter = self.value_inter.infer(ev, ev.pool(val, is_value_head=True))
        ownership = torch.tanh(
            (ev.conv(self.ownership_conv, val_lo) * ev.m4).reshape(b, hw).float()
        )
        ev.record()
        return self._outputs(pol_spatial, pol_pass, ownership,
                             self.value_misc.infer(ev, val_inter))

    @staticmethod
    def _outputs(pol_spatial, pol_pass, ownership, val_misc):
        """The heads' dict from the policy planes [B, HW, 5], the pass logits
        [B, 5], the ownership [B, HW] and the value head's outputs."""
        pol_all = torch.cat([pol_spatial, pol_pass[:, None, :]], 1).float()
        val_misc = val_misc.float()
        errors = softplus_with_gradient_floor(val_misc[:, 13:15])
        return {
            "prob": pol_all[:, :, 0],
            "aux_prob": pol_all[:, :, 1],
            "soft_prob": pol_all[:, :, 2],
            "soft_aux_prob": pol_all[:, :, 3],
            "optimistic_prob": pol_all[:, :, 4],
            "ownership": ownership,
            "wdl": val_misc[:, 0:3],
            "q_vals": torch.tanh(val_misc[:, 3:8]),
            "scores": 20.0 * val_misc[:, 8:13],
            "errors": torch.stack([0.25 * errors[:, 0], 150.0 * errors[:, 1]], 1),
        }
