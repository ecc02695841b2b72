"""Plain PyTorch reference of the policy/value net the configurations name.

Written from the architecture (the reference engine's nets with masked
batch norm: residual, bottleneck, nested-bottleneck and mixer blocks, each
with optional squeeze-excite; a global-pooling policy head, "Normal" or
"RepLK" with a large-kernel depthwise and a pointwise conv before it; a
value head of 15 outputs plus ownership), in float32 with TF32 off, with no
kernel, cache or batching of the measured program. It reads only the
configuration's sizes and the weights the harness makes (`make_weights`),
which are handed to both sides under the measured program's state_dict
names.

The blocks, as the architecture states them (c the trunk's channels):
- ResidualBlock: 3x3 conv, 3x3 conv, the skip;
- BottleneckBlock: 1x1 to c/2, two 3x3 convs at c/2, 1x1 back to c, the skip;
- NestedBottleneckBlock: 1x1 to c/2, two residual blocks at c/2, 1x1 back
  to c, the skip;
- MixerBlock (V1) and MixerBlockV2: a depthwise block (a 7x7 and a 3x3
  depthwise conv, each with its broadcast effective kernel
  w + sum_c(w_c * gamma_c) and its bias, summed), then a 1x1 FFN to
  int(1.5 c) and back; V1 adds the block's input to the depthwise block's
  output and takes that sum as the FFN's input and the final skip, V2 has
  the block's input as its only skip.
A spec names its parts joined by "-": the last block named sets the
family, "MixerBlockV2" anywhere sets the mixer's version to 2 (no other name
resets it), "SE" anywhere adds squeeze-excite before the skip.

The activation is the configuration's (`relu` or `mish`).

`forward(..., quant="fp8")` is the control: the same net with every conv
(the depthwise ones included) and dense input and weight rounded to float8
e4m3 (per-tensor scale), the precision step below the bfloat16 the search
serves in.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CRAZY_NEGATIVE_VALUE = -5000.0
B_AVG = (19 + 9) / 2
B_VARIANCE = 0.1
BN_EPS = 1e-5
ACTIVATIONS = {"relu": F.relu, "mish": F.mish}
# a spec's block names -> family
FAMILIES = {"ResidualBlock": "residual", "BottleneckBlock": "bottleneck",
            "NestedBottleneckBlock": "nested", "MixerBlock": "mixer",
            "MixerBlockV1": "mixer", "MixerBlockV2": "mixer"}
MIXER_KERNEL = 7
FFN_RATIO = 1.5


def blocks(cfg):
    """[(family, mixer version, has_se)] for each tower block; the version
    is 0 for a block that is no mixer."""
    out = []
    for spec in cfg["stack"]:
        kind, version, se = None, 1, False
        for part in spec.strip().split("-"):
            if part == "SE":
                se = True
            elif part in FAMILIES:
                kind = FAMILIES[part]
                if part == "MixerBlockV2":
                    version = 2
            else:
                raise ValueError(f"unknown block component {part!r} in {spec!r}")
        if kind is None:
            raise ValueError(f"no block in {spec!r}")
        out.append((kind, version if kind == "mixer" else 0, se))
    return out


def param_shapes(cfg):
    """{name: shape} in the measured program's state_dict naming."""
    c, cin = cfg["residual_channels"], cfg["input_channels"]
    pc, vc = cfg["policy_head_channels"], cfg["value_head_channels"]
    se = c // cfg["se_ratio"]
    shapes = {}

    def bn(name, o, gamma):
        shapes[f"{name}.bn.beta"] = (o,)
        if gamma:
            shapes[f"{name}.bn.gamma"] = (o,)
        shapes[f"{name}.bn.mean"] = (o,)
        shapes[f"{name}.bn.var"] = (o,)

    def conv_block(name, i, o, k, gamma):
        shapes[f"{name}.conv.weight"] = (o, i, k, k)
        bn(name, o, gamma)

    def dw_block(name, ch, k, gamma):
        for sub, kk in (("conv", k), ("rep3x3", 3)):
            shapes[f"{name}.{sub}.weight"] = (ch, 1, kk, kk)
            shapes[f"{name}.{sub}.gamma"] = (ch,)
            shapes[f"{name}.{sub}.bias"] = (ch,)
        bn(name, ch, gamma)

    def dense(name, i, o):
        shapes[f"{name}.fc.weight"] = (o, i)
        shapes[f"{name}.fc.bias"] = (o,)

    def residual(name, ch):
        conv_block(f"{name}.conv1", ch, ch, 3, False)
        conv_block(f"{name}.conv2", ch, ch, 3, True)

    conv_block("input_conv", cin, c, 3, True)
    for i, (kind, _, has_se) in enumerate(blocks(cfg)):
        t, h = f"tower.{i}", c // 2
        if kind == "residual":
            residual(t, c)
        elif kind == "bottleneck":
            conv_block(f"{t}.pre", c, h, 1, False)
            conv_block(f"{t}.conv1", h, h, 3, False)
            conv_block(f"{t}.conv2", h, h, 3, False)
            conv_block(f"{t}.post", h, c, 1, True)
        elif kind == "nested":
            conv_block(f"{t}.pre", c, h, 1, False)
            residual(f"{t}.block1", h)
            residual(f"{t}.block2", h)
            conv_block(f"{t}.post", h, c, 1, True)
        else:
            ffn = int(FFN_RATIO * c)
            dw_block(f"{t}.dw", c, MIXER_KERNEL, True)
            conv_block(f"{t}.ffn1", c, ffn, 1, False)
            conv_block(f"{t}.ffn2", ffn, c, 1, True)
        if has_se:
            dense(f"{t}.se.squeeze", 3 * c, se)
            dense(f"{t}.se.excite", se, 2 * c)
    conv_block("policy_conv", c, pc, 1, False)
    if cfg["policy_head_type"] == "RepLK":
        dw_block("policy_dw", pc, max(cfg.get("policy_head_kernel", 7), 7), False)
        conv_block("policy_pw", pc, pc, 1, True)
    dense("policy_inter", 3 * pc, pc)
    shapes["pol_misc.weight"] = (cfg["policy_outs"], pc, 1, 1)
    shapes["pol_misc.bias"] = (cfg["policy_outs"],)
    dense("pol_pass", pc, cfg["policy_outs"])
    conv_block("value_conv", c, vc, 1, False)
    dense("value_inter", 3 * vc, 3 * vc)
    shapes["ownership_conv.weight"] = (1, vc, 1, 1)
    shapes["ownership_conv.bias"] = (1,)
    dense("value_misc", 3 * vc, cfg["value_misc"])
    return shapes


def make_weights(cfg, seed: int, device) -> dict:
    """Seeded float32 weights on `device` from two calls of one generator:
    xavier-normal kernels (the depthwise ones [C, 1, k, k] by the same
    rule), biases and BN shifts N(0, 0.1), BN gammas 1 + N(0, 0.1), the
    depthwise kernels' broadcast gammas (1 + N(0, 0.1)) / sqrt(C), running
    variances U(0.5, 1.5)."""
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        z = normal[at:at + size].view(shape)
        u = uniform[at:at + size].view(shape)
        at += size
        if name.endswith("weight") and len(shape) >= 2:
            rf = math.prod(shape[2:]) if len(shape) == 4 else 1
            std = math.sqrt(2.0 / ((shape[0] + shape[1]) * rf))
            out[name] = (z * std).contiguous()
        elif name.endswith(".bn.gamma"):
            out[name] = 1.0 + 0.1 * z
        elif name.endswith(".gamma"):     # a depthwise kernel's broadcast gammas
            out[name] = (1.0 + 0.1 * z) / math.sqrt(shape[0])
        elif name.endswith(".var"):
            out[name] = 0.5 + u
        else:                      # biases, BN betas and running means
            out[name] = 0.1 * z
    return out


def _fp8(x):
    """Round to float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Ops:
    def __init__(self, w, quant, act):
        self.w = w
        self.act = act
        self.q = _fp8 if quant == "fp8" else (lambda t: t)

    def conv(self, name, x, bias=None):
        wt = self.w[name]
        return F.conv2d(self.q(x), self.q(wt), bias, padding=wt.shape[-1] // 2)

    def dwconv(self, name, x):
        """A depthwise conv with its broadcast effective kernel and bias."""
        wt = self.w[f"{name}.weight"]
        wt = wt + (wt * self.w[f"{name}.gamma"][:, None, None, None]).sum(0, keepdim=True)
        return F.conv2d(self.q(x), self.q(wt), self.w[f"{name}.bias"],
                        padding=wt.shape[-1] // 2, groups=wt.shape[0])

    def dense(self, name, x, act=False):
        y = F.linear(self.q(x), self.q(self.w[f"{name}.fc.weight"]), self.w[f"{name}.fc.bias"])
        return self.act(y) if act else y

    def bn(self, name, x, mask):
        scale = torch.rsqrt(self.w[f"{name}.bn.var"] + BN_EPS)
        if f"{name}.bn.gamma" in self.w:
            scale = scale * self.w[f"{name}.bn.gamma"]
        bias = self.w[f"{name}.bn.beta"] - self.w[f"{name}.bn.mean"] * scale
        return (x * scale[None, :, None, None] + bias[None, :, None, None]) * mask

    def conv_block(self, name, x, mask, act=True):
        y = self.bn(name, self.conv(f"{name}.conv.weight", x) * mask, mask)
        return self.act(y) if act else y

    def dw_block(self, name, x, mask):
        """The k x k and the 3x3 depthwise convs, summed, then BN and act."""
        y = self.dwconv(f"{name}.conv", x) + self.dwconv(f"{name}.rep3x3", x)
        return self.act(self.bn(name, y * mask, mask))

    def residual(self, name, x, mask):
        """A residual block's two convs, before its SE and skip."""
        y = self.conv_block(f"{name}.conv1", x, mask)
        return self.conv_block(f"{name}.conv2", y, mask, act=False)


def _gpool(x, mask, msum, msqrt, value_head=False):
    mean = x.sum((2, 3)) / msum[:, None]
    b_diff = msqrt[:, None] - B_AVG
    l1 = mean * (b_diff / 10.0)
    if value_head:
        l2 = mean * (torch.square(b_diff) / 100.0 - B_VARIANCE)
    else:
        l2 = (x + (1.0 - mask) * CRAZY_NEGATIVE_VALUE).amax((2, 3))
    return torch.cat([mean, l1, l2], 1)


def forward(cfg, w, planes, quant=None):
    """planes [B, H, W, 43] float32 -> (policy logits [B, HW+1], wdl logits
    [B, 3])."""
    logits, misc = _forward(cfg, w, planes, quant)
    return logits, misc[:, 0:3]


def _block(ops, name, kind, version, x, mask):
    """(the block's output before its SE and skip, the skip)."""
    if kind == "residual":
        return ops.residual(name, x, mask), x
    if kind == "bottleneck":
        y = ops.conv_block(f"{name}.pre", x, mask)
        y = ops.conv_block(f"{name}.conv1", y, mask)
        y = ops.conv_block(f"{name}.conv2", y, mask)
        return ops.conv_block(f"{name}.post", y, mask, act=False), x
    if kind == "nested":
        y = ops.conv_block(f"{name}.pre", x, mask)
        y = ops.act(ops.residual(f"{name}.block1", y, mask) + y)
        y = ops.act(ops.residual(f"{name}.block2", y, mask) + y)
        return ops.conv_block(f"{name}.post", y, mask, act=False), x
    y = ops.dw_block(f"{name}.dw", x, mask)
    if version == 1:
        x = y = y + x
    y = ops.conv_block(f"{name}.ffn1", y, mask)
    return ops.conv_block(f"{name}.ffn2", y, mask, act=False), x


def _forward(cfg, w, planes, quant):
    if cfg["activation"] not in ACTIVATIONS or cfg["policy_head_type"] not in ("Normal", "RepLK"):
        raise ValueError("the reference knows relu and mish nets with the Normal or RepLK "
                         "policy head")
    ops = _Ops(w, quant, ACTIVATIONS[cfg["activation"]])
    b, h, wd, _ = planes.shape
    x = planes.permute(0, 3, 1, 2).float()
    mask = x[:, cfg["input_channels"] - 1:]
    msum = mask.sum((1, 2, 3))
    msqrt = torch.sqrt(msum)
    x = ops.conv_block("input_conv", x, mask)
    for i, (kind, version, has_se) in enumerate(blocks(cfg)):
        y, x = _block(ops, f"tower.{i}", kind, version, x, mask)
        if has_se:
            s = ops.dense(f"tower.{i}.se.excite",
                          ops.dense(f"tower.{i}.se.squeeze", _gpool(y, mask, msum, msqrt), act=True))
            gam, bet = s.chunk(2, dim=1)
            y = (torch.sigmoid(gam)[:, :, None, None] * y + bet[:, :, None, None]) * mask
        x = ops.act(y + x)
    pol = ops.conv_block("policy_conv", x, mask)
    if cfg["policy_head_type"] == "RepLK":
        pol = ops.conv_block("policy_pw", ops.dw_block("policy_dw", pol, mask), mask)
    inter = ops.dense("policy_inter", _gpool(pol, mask, msum, msqrt), act=True)
    pol = (pol + inter[:, :, None, None]) * mask
    spatial = ops.conv("pol_misc.weight", pol, w["pol_misc.bias"])[:, 0:1]
    spatial = spatial * mask + (1.0 - mask) * CRAZY_NEGATIVE_VALUE
    pas = ops.dense("pol_pass", inter)[:, 0:1]
    logits = torch.cat([spatial.reshape(b, h * wd), pas], 1)
    val = ops.conv_block("value_conv", x, mask)
    vin = ops.dense("value_inter", _gpool(val, mask, msum, msqrt, value_head=True), act=True)
    return logits, ops.dense("value_misc", vin)
