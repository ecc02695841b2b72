"""The card's peaks and the operations and bytes of one net evaluation,
which `mfu.*` and the `*_roofline` readers divide by.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity),
which hold at the full 700 W power limit; every run prints the card's
name and power limit (`card`) beside its numbers.

The counts are the algorithm's, from the configuration's shapes, not the
profiler's: 2 * H * W * k^2 * C_in * C_out a convolution, 2 * in * out a
dense layer and a row, over every cell of the board buffer.
"""

from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12      # dense bf16 tensor-core peak
F32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SOURCE = "NVIDIA H100 SXM data sheet, dense rates without sparsity"


def card():
    """[name, power limit] as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return [x.strip() for x in res.stdout.strip().splitlines()[0].split(",")]


def layers(net):
    """[(kind, cin, cout, k)] of the forward pass: 'conv' layers over the
    board, 'dense' layers once a row."""
    c, cin = net["residual_channels"], net["input_channels"]
    pc, vc = net["policy_head_channels"], net["value_head_channels"]
    se = c // net["se_ratio"]
    out = [("conv", cin, c, 3)]
    for spec in net["stack"]:
        out += [("conv", c, c, 3), ("conv", c, c, 3)]
        if spec.endswith("-SE"):
            out += [("dense", 3 * c, se, 1), ("dense", se, 2 * c, 1)]
    out += [("conv", c, pc, 1), ("dense", 3 * pc, pc, 1), ("conv", pc, net["policy_outs"], 1),
            ("dense", pc, net["policy_outs"], 1),
            ("conv", c, vc, 1), ("dense", 3 * vc, 3 * vc, 1), ("conv", vc, 1, 1),
            ("dense", 3 * vc, net["value_misc"], 1)]
    return out


def forward_flops(net):
    """Operations of one evaluation's forward pass."""
    hw = net["boardsize"] ** 2
    return sum(2 * (hw if kind == "conv" else 1) * k * k * i * o
               for kind, i, o, k in layers(net))


def forward_bytes(net, rows, act_bytes=2, weight_bytes=2):
    """Bytes of one forward pass over `rows` positions: every weight once,
    and each layer's input and output once."""
    hw = net["boardsize"] ** 2
    weights = sum(k * k * i * o for _, i, o, k in layers(net)) * weight_bytes
    acts = sum((hw if kind == "conv" else 1) * (i + o) for kind, i, o, _ in layers(net))
    return weights + rows * acts * act_bytes
