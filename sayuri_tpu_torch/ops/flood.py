"""Board fixpoint kernels (CUDA, csrc/flood.cu) behind ``flood`` and
``chain_labels`` of game/board.py.

- ``flood`` replaces the Pallas ``_flood_kernel`` (sayuri_tpu/ops/flood.py,
  entry ``flood_tpu``): grow ``seed & allowed`` within ``allowed`` over
  4-connected cells.
- ``chain_labels`` replaces the Pallas ``_labels_kernel`` (entry
  ``chain_labels_tpu``): the min flat index of each 4-connected component,
  -1 off it, as int64 (the plain version's type, which gather and scatter
  take as an index).

Both take boards ``[..., n, n]`` with any leading shape. Given CPU tensors
they run the plain versions (game/board.py ``flood_plain``,
``chain_labels_plain``); given CUDA tensors they launch one kernel over all
leading dimensions collapsed, or raise. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.ops.analysis import MAX_N, _ptr, _raise_if

# kernel launches per entry point (CUDA tensors only; the plain versions
# never count)
LAUNCHES = {"flood": 0, "chain_labels": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    from sayuri_tpu_torch.ops import build

    return bind(build.load("flood"))


def bind(lib):
    """Set the argument and result types of flood.cu's launchers on a
    loaded library; returns it."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.launch_labels.argtypes = [vp, vp, ll, i, vp]
    lib.launch_labels.restype = i
    lib.launch_flood.argtypes = [vp, vp, vp, ll, i, vp]
    lib.launch_flood.restype = i
    return lib


def _check_boards(name, t, shape=None):
    """Boards the kernels take: bool [..., n, n], contiguous, n <= MAX_N.
    Returns (number of boards, n)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.bool:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.bool")
    if t.ndim < 2 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected [..., n, n]")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    n = t.shape[-1]
    if n > MAX_N:
        raise ValueError(f"{name}: board buffer n={n} exceeds {MAX_N}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.numel() // (n * n), n


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def chain_labels(stone_mask):
    """[..., n, n] bool -> [..., n, n] int64 min-flat-index component
    labels, -1 off the mask."""
    if stone_mask.device.type == "cpu":
        return B.chain_labels_plain(stone_mask)
    if stone_mask.device.type != "cuda":
        raise ValueError(f"chain_labels: unsupported device {stone_mask.device}")
    boards, n = _check_boards("stone_mask", stone_mask)
    out = torch.empty(stone_mask.shape, dtype=torch.int64, device=stone_mask.device)
    if boards:
        rc = _lib().launch_labels(_ptr(stone_mask), _ptr(out), boards, n,
                                  _stream(stone_mask))
        _raise_if(rc, "chain_labels")
        LAUNCHES["chain_labels"] += 1
    return out


def flood(seed, allowed):
    """[..., n, n] bool seed and allowed (same shape) -> [..., n, n] bool:
    the cells of `allowed` connected within `allowed` to a seeded cell."""
    if allowed.device.type == "cpu":
        return B.flood_plain(seed, allowed)
    if allowed.device.type != "cuda":
        raise ValueError(f"flood: unsupported device {allowed.device}")
    boards, n = _check_boards("allowed", allowed)
    _check_boards("seed", seed, allowed.shape)
    if seed.device != allowed.device:
        raise ValueError(f"seed: on {seed.device}, expected {allowed.device}")
    out = torch.empty_like(allowed)
    if boards:
        rc = _lib().launch_flood(_ptr(seed), _ptr(allowed), _ptr(out), boards, n,
                                 _stream(allowed))
        _raise_if(rc, "flood")
        LAUNCHES["flood"] += 1
    return out
