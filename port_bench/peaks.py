"""The card's peaks and the operations and bytes of one net evaluation,
which `mfu.*` and the `*_roofline` readers divide by.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity),
which hold at the full 700 W power limit; every run prints the card's
name and power limit (`card`) beside its numbers.

The counts are the algorithm's, from the configuration's shapes, not the
profiler's: 2 * H * W * k^2 * C_in * C_out a convolution, 2 * H * W * k^2 * C
a depthwise one, 2 * in * out a dense layer and a row, over every cell of
the board buffer; every kernel of the net's parameters once.
"""

from __future__ import annotations

import subprocess

from port_bench.reference import net as N

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
    """[(kind, cin, cout, k)] of the forward pass, one a kernel of the net's
    parameters (reference/net.py `param_shapes`, which the program loads
    strictly): 'conv' layers over the board, 'dwconv' depthwise convs over
    the board (one k x k kernel a channel; a depthwise block's 3x3 kernel is
    merged into its k x k one, as the program runs it), 'dense' layers once
    a row."""
    shapes = N.param_shapes(net)
    out = []
    for name, shape in shapes.items():
        if not name.endswith("weight") or name.endswith("rep3x3.weight"):
            continue
        if len(shape) == 2:
            out.append(("dense", shape[1], shape[0], 1))
        elif name[:-len("weight")] + "gamma" in shapes:    # a broadcast depthwise kernel
            out.append(("dwconv", shape[0], shape[0], shape[-1]))
        else:
            out.append(("conv", shape[1], shape[0], shape[-1]))
    return out


def _macs(kind, i, o, k):
    """Multiply-adds of a layer at one cell (conv) or one row (dense)."""
    return k * k * (i if kind == "dwconv" else i * o)


def forward_flops(net):
    """Operations of one evaluation's forward pass."""
    hw = net["boardsize"] ** 2
    return sum(2 * (1 if kind == "dense" else hw) * _macs(kind, i, o, k)
               for kind, i, o, k in layers(net))


def forward_bytes(net, rows, act_bytes=2, weight_bytes=2):
    """Bytes of one forward pass over `rows` positions: every weight once,
    and each layer's input and output once."""
    hw = net["boardsize"] ** 2
    weights = sum(_macs(*layer) for layer in layers(net)) * weight_bytes
    acts = sum((1 if kind == "dense" else hw) * (i + o) for kind, i, o, _ in layers(net))
    return weights + rows * acts * act_bytes
