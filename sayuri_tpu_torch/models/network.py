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
- blocks: ResidualBlock and ResidualBlock-SE (the default b6c96 stack);
- the "Normal" policy head emits 5 spatial policy planes + 5 pass logits;
  the value head emits 15 values = wdl(3) + q_vals(5) + scores(5) +
  errors(2), plus tanh ownership.

Convolutions run through cuDNN (``F.conv2d``) in NCHW; the public call
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
    policy_head_type: str = "Normal"
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
    is plain masked batch norm)."""

    def __init__(self, features: int, use_gamma: bool, eps: float = 1e-5,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
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
        mean = xf.sum((0, 2, 3)) / mask_sum
        zm = (xf - mean[:, None, None]) * mask
        var = torch.square(zm).sum((0, 2, 3)) / mask_sum
        std = torch.sqrt(var + self.eps)
        r_std = torch.sqrt(self.var + self.eps)
        r = torch.clamp(std.detach() / r_std, 1.0 / self.rmax, self.rmax)
        d = torch.clamp((mean.detach() - self.mean) / r_std, -self.dmax, self.dmax)
        out = (xf - mean[:, None, None]) / std[:, None, None] * r[:, None, None] \
            + d[:, None, None]
        m = BN_MOMENTUM * math.sqrt(x.shape[0] / BN_BASIC_BATCH)
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


class ResidualBlock(nn.Module):
    def __init__(self, features: int, se_size: int | None, activation: str,
                 rmax: float = 1.0, dmax: float = 0.0):
        super().__init__()
        self.conv1 = ConvBlock(features, features, 3, False, activation, rmax, dmax)
        self.conv2 = ConvBlock(features, features, 3, True, "identity", rmax, dmax)
        self.se = (
            SqueezeExcite(features, se_size, activation) if se_size else None
        )
        self.act = act_fn(activation)

    def forward(self, x, mask, msum, msqrt):
        out = self.conv2(self.conv1(x, mask), mask)
        if self.se is not None:
            out = self.se(out, mask, msum, msqrt)
        return self.act(out + x)


def _parse_block(spec: str, cfg: NetConfig):
    parts = spec.strip().split("-")
    if parts[0] != "ResidualBlock" or any(p != "SE" for p in parts[1:]):
        raise ValueError(
            f"block {spec!r}: only ResidualBlock and ResidualBlock-SE are ported"
        )
    se_size = cfg.residual_channels // cfg.se_ratio if "SE" in parts else None
    return ResidualBlock(cfg.residual_channels, se_size, cfg.activation,
                         cfg.renorm_max_r, cfg.renorm_max_d)


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
        if cfg.policy_head_type != "Normal":
            raise ValueError("only the Normal policy head is ported")
        self.cfg = cfg
        c, pc, vc = (cfg.residual_channels, cfg.policy_head_channels,
                     cfg.value_head_channels)
        a, rd = cfg.activation, (cfg.renorm_max_r, cfg.renorm_max_d)
        self.input_conv = ConvBlock(cfg.input_channels, c, 3, True, a, *rd)
        self.tower = nn.ModuleList(_parse_block(s, cfg) for s in cfg.stack)
        self.policy_conv = ConvBlock(c, pc, 1, False, a, *rd)
        self.policy_inter = Dense(3 * pc, pc, a)
        self.pol_misc = nn.Conv2d(pc, cfg.policy_outs, 1)
        self.pol_pass = Dense(pc, cfg.policy_outs)
        self.value_conv = ConvBlock(c, vc, 1, False, a, *rd)
        self.value_inter = Dense(3 * vc, 3 * vc, a)
        self.ownership_conv = nn.Conv2d(vc, 1, 1)
        self.value_misc = Dense(3 * vc, cfg.value_misc)

    def init_random(self, seed: int = 0):
        """Seeded random weights: xavier-normal kernels, zero biases, unit
        BN statistics."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    w = m.weight
                    rf = w[0][0].numel() if w.ndim == 4 else 1
                    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
                    std = math.sqrt(2.0 / (fan_in + fan_out))
                    w.copy_(torch.randn(w.shape, generator=g) * std)
                    if m.bias is not None:
                        m.bias.zero_()
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
