"""The eval-mode epilogue of the net's conv blocks (CUDA, csrc/epilogue.cu):
the mask, the folded batch norm, the squeeze-excite scale, the skip add and
the activation after a conv, in one pass over an NHWC tensor.

It replaces no TPU kernel (the JAX package leaves this work to XLA's
fusion): it replaces the chain of ATen elementwise kernels that eager
PyTorch runs after each cuDNN conv of the eval forward
(``models/network.py``). The arithmetic is the chain's, in float32 and in
its order; what changes is the number of passes over the tensor and of
launches. csrc/epilogue.cu says how the kernel meets its bound (bytes).

``epilogue`` takes CPU tensors through ``epilogue_plain``, the same
formulas in PyTorch, and CUDA tensors through one kernel launch, or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sayuri_tpu_torch.ops.analysis import _raise_if

# kernel launches (CUDA tensors only; the plain version never counts)
LAUNCHES = {"epilogue": 0}

# the net's activations (models/network.py act_fn), in the order of
# csrc/epilogue.cu's ACT_* ids
ACT_FNS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": F.gelu,
    "mish": F.mish,
    "swish": F.silu,
    "hardswish": F.hardswish,
}
ACTS = tuple(ACT_FNS)
# the most channel groups (C / 8, or C) a block holds
MAX_GROUPS = 1024


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    from sayuri_tpu_torch.ops import build

    return bind(build.load("epilogue"))


def bind(lib):
    """Set the argument and result types of epilogue.cu's launcher on a
    loaded library; returns it."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.launch_epilogue.argtypes = [vp, i, vp, vp, vp, vp, i, vp, i, i, vp, vp, ll, i, i,
                                    i, i, vp]
    lib.launch_epilogue.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(index):
    """Blocks of one full-occupancy wave on the card: the grid-stride
    loop's grid."""
    return torch.cuda.get_device_properties(index).multi_processor_count * 8


def epilogue_plain(x, m, scale=None, bias=None, se=None, skip=None, skip_after_act=False,
                   act="identity", out_f32=True, out_lo=None):
    """The epilogue in PyTorch, in the order of the eval ConvBlock, the
    SqueezeExcite and the block tail (``_Block``) it replaces:

        y = (x * m * scale + bias) * m            with scale and bias
        y = (sigmoid(g) * y + beta) * m           with se = [g | beta]
        y = act(y + skip)                         or act(y) + skip

    `x` [B, H, W, C] (any float dtype; float32 arithmetic from the first
    multiply by the float32 mask on; without scale and bias, float32), `m`
    [B, H, W] float32, `scale` and `bias` [C] float32, `se` [B, 2C] (the
    excite layer's output in its own dtype: the sigmoid runs in that dtype,
    as the module's does), `skip` [B, H, W, C] float32. Returns (float32 y
    or None, y cast to `out_lo` or None)."""
    mk = m[..., None]
    y = x
    if scale is not None:
        y = (x * mk) * scale + bias
        y = y * mk
    if se is not None:
        g, beta = se.chunk(2, dim=1)
        y = torch.sigmoid(g)[:, None, None, :] * y + beta[:, None, None, :]
        y = y * mk
    if skip is not None and not skip_after_act:
        y = y + skip
    # the activation sees the NCHW view, the layout of the modules' forward:
    # the CPU's gelu rounds apart on an NHWC-contiguous tensor
    y = ACT_FNS[act](y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    if skip is not None and skip_after_act:
        y = y + skip
    return (y if out_f32 else None), (y.to(out_lo) if out_lo is not None else None)


_F32 = (torch.float32,)
_IN = (torch.bfloat16, torch.float32)


def _check(name, t, shape, dtypes=_F32):
    """`t` contiguous, of `shape` and one of `dtypes`, or an error."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous (NHWC)")


def launch_args(x, m, scale=None, bias=None, se=None, skip=None, skip_after_act=False,
                act="identity", out_f32=True, out_lo=None, max_blocks=1):
    """Check the inputs, allocate the outputs and build the launcher's
    arguments (csrc/epilogue.cu `launch_epilogue`, stream excluded):
    (arguments, float32 output or None, bf16 output or None)."""
    shape = x.shape
    if len(shape) != 4:
        raise ValueError(f"x: shape {tuple(shape)}, expected [B, H, W, C]")
    b, h, w, c = shape
    _check("x", x, shape, _IN)
    _check("m", m, shape[:3])
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias: give both or neither")
    if scale is not None:
        _check("scale", scale, shape[3:])
        _check("bias", bias, shape[3:])
    if se is not None:
        _check("se", se, (b, 2 * c), _IN)
    if skip is not None:
        _check("skip", skip, shape)
    if act not in ACTS:
        raise ValueError(f"act {act!r}: use one of {ACTS}")
    if out_lo is torch.float32:
        # one float32 output serves both
        out_f32, out_lo = True, None
    elif out_lo is not None and out_lo is not torch.bfloat16:
        raise TypeError(f"out_lo: {out_lo}, expected torch.bfloat16 or torch.float32")
    if not out_f32 and out_lo is None:
        raise ValueError("no output asked for")
    dev = x.device
    for name, t in (("m", m), ("scale", scale), ("se", se), ("skip", skip)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
    y32 = torch.empty(shape, dtype=torch.float32, device=dev) if out_f32 else None
    ylo = torch.empty(shape, dtype=out_lo, device=dev) if out_lo is not None else None
    px = x.data_ptr()
    pskip = skip.data_ptr() if skip is not None else None
    # the allocator's blocks are 512-byte aligned; a view may not be
    vec = c % 8 == 0 and px % 16 == 0 and (pskip or 0) % 16 == 0
    if (c // 8 if vec else c) > MAX_GROUPS:
        raise ValueError(f"x: {c} channels, more than the kernel's {MAX_GROUPS} groups")
    args = (px, x.dtype is torch.bfloat16, m.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            se.data_ptr() if se is not None else None,
            se is not None and se.dtype is torch.bfloat16, pskip,
            0 if skip is None else 2 if skip_after_act else 1, ACTS.index(act),
            y32.data_ptr() if y32 is not None else None,
            ylo.data_ptr() if ylo is not None else None, b * h * w, h * w, c, vec,
            max_blocks)
    return args, y32, ylo


def epilogue(x, m, scale=None, bias=None, se=None, skip=None, skip_after_act=False,
             act="identity", out_f32=True, out_lo=None):
    """The epilogue of ``epilogue_plain`` (same arguments and results): on
    CPU tensors the plain version, on CUDA tensors one kernel launch (x
    bfloat16 or float32, `out_lo` bfloat16 or float32, every tensor
    contiguous), or an error."""
    if x.device.type == "cpu":
        return epilogue_plain(x, m, scale, bias, se, skip, skip_after_act, act, out_f32,
                              out_lo)
    if x.device.type != "cuda":
        raise ValueError(f"epilogue: unsupported device {x.device}")
    index = x.get_device()
    args, y32, ylo = launch_args(x, m, scale, bias, se, skip, skip_after_act, act, out_f32,
                                 out_lo, _max_blocks(index))
    _raise_if(_lib().launch_epilogue(*args, torch._C._cuda_getCurrentRawStream(index)),
              "epilogue")
    LAUNCHES["epilogue"] += 1
    if out_lo == torch.float32:
        return y32, y32
    return y32, ylo
