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
ones) in NCHW; the public call
takes NHWC planes like the JAX package. For bf16, wrap the call in
``torch.autocast``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

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


_ACTS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": F.gelu,
    "mish": F.mish,
    "swish": F.silu,
    "hardswish": F.hardswish,
}


def act_fn(name: str):
    return _ACTS[name]


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
        scale = torch.rsqrt(self.var + self.eps)
        if self.gamma is not None:
            scale = scale * self.gamma
        bias = self.beta - self.mean * scale
        out = x * scale[None, :, None, None] + bias[None, :, None, None]
        return out * mask

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
        self.act = act_fn(activation)

    def forward(self, x, mask):
        return self.act(self.bn(self.conv(x) * mask, mask))


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
        self.act = act_fn(activation)

    def conv2d(self, x):
        k = self.conv.weight.shape[-1]
        p = (k - 3) // 2
        w = self.conv.effective_weight() + F.pad(self.rep3x3.effective_weight(), (p, p, p, p))
        return F.conv2d(x, w, self.conv.bias + self.rep3x3.bias, padding=k // 2,
                        groups=w.shape[0])

    def forward(self, x, mask):
        return self.act(self.bn(self.conv2d(x) * mask, mask))


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, activation: str = "identity"):
        super().__init__()
        self.fc = nn.Linear(cin, cout)
        self.act = act_fn(activation)

    def forward(self, x):
        return self.act(self.fc(x))


def global_pool(x, mask, msum, msqrt, is_value_head=False):
    """[B, C, H, W] -> [B, 3C]."""
    xf = x.float()
    div = msum[:, None]
    mean = xf.sum((2, 3)) / div
    b_diff = msqrt[:, None] - B_AVG
    if is_value_head:
        l1 = mean * (b_diff / 10.0)
        l2 = mean * (torch.square(b_diff) / 100.0 - B_VARIANCE)
    else:
        raw = xf + (1.0 - mask.float()) * CRAZY_NEGATIVE_VALUE
        l1 = mean * (b_diff / 10.0)
        l2 = raw.amax((2, 3))
    return torch.cat([mean, l1, l2], 1).to(x.dtype)


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


class _Block(nn.Module):
    """A tower block's tail: the optional SE (``self.se``), then
    act(out + skip) (``self.act``)."""

    def _finish(self, out, skip, mask, msum, msqrt):
        if self.se is not None:
            out = self.se(out, mask, msum, msqrt)
        return self.act(out + skip)


def _se(features: int, se_size: int | None, activation: str):
    return SqueezeExcite(features, se_size, activation) if se_size else None


class ResidualBlock(_Block):
    def __init__(self, features: int, se_size: int | None, activation: str,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        self.conv1 = ConvBlock(features, features, 3, False, activation, rmax, dmax)
        self.conv2 = ConvBlock(features, features, 3, True, "identity", rmax, dmax)
        self.se = _se(features, se_size, activation)
        self.act = act_fn(activation)

    def forward(self, x, mask, msum, msqrt):
        out = self.conv2(self.conv1(x, mask), mask)
        return self._finish(out, x, mask, msum, msqrt)


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
        self.act = act_fn(a)

    def forward(self, x, mask, msum, msqrt):
        out = self.pre(x, mask)
        out = self.conv2(self.conv1(out, mask), mask)
        return self._finish(self.post(out, mask), x, mask, msum, msqrt)


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
        self.act = act_fn(a)

    def forward(self, x, mask, msum, msqrt):
        out = self.pre(x, mask)
        out = self.block2(self.block1(out, mask, msum, msqrt), mask, msum, msqrt)
        return self._finish(self.post(out, mask), x, mask, msum, msqrt)


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
        self.act = act_fn(a)

    def forward(self, x, mask, msum, msqrt):
        if self.version == 1:
            x = self.dw(x, mask) + x
            out = x
        else:
            out = self.dw(x, mask)
        out = self.ffn2(self.ffn1(out, mask), mask)
        return self._finish(out, x, mask, msum, msqrt)


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
        pol_all = torch.cat([pol_spatial, pol_pass[:, None, :]], 1).float()

        # ---- value head ----
        val = self.value_conv(x, mask)
        val_inter = self.value_inter(
            global_pool(val, mask, msum, msqrt, is_value_head=True)
        )
        ownership = torch.tanh(
            (self.ownership_conv(val) * mask).reshape(b, hw).float()
        )
        val_misc = self.value_misc(val_inter).float()
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
