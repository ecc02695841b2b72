"""Dihedral (8-fold) symmetry transforms for planes and policies (PyTorch
port of sayuri_tpu.models.symmetry).

Symmetry index encoding: bit 0 = horizontal flip (x), bit 1 = vertical
flip (y), bit 2 = transpose (applied first on the forward transform).
Planes keep the JAX package's channels-last layout [..., H, W, C].
"""

from __future__ import annotations

import torch


def transform_planes(x, sym: int):
    """Apply symmetry `sym` (int in [0, 8)) to [..., H, W, C]."""
    if sym & 4:
        x = x.transpose(-3, -2)
    if sym & 2:
        x = x.flip(-3)
    if sym & 1:
        x = x.flip(-2)
    return x


def inverse_transform_planes(x, sym: int):
    if sym & 1:
        x = x.flip(-2)
    if sym & 2:
        x = x.flip(-3)
    if sym & 4:
        x = x.transpose(-3, -2)
    return x


def _spatial_transform_batch(x, syms, inverse: bool):
    """Per-row dihedral transform of [B, H, W] or [B, H, W, C]: three
    flip/transpose steps, each selected per row."""
    hw = (-3, -2) if x.ndim >= 4 else (-2, -1)
    sb = syms.view(syms.shape + (1,) * (x.ndim - 1))
    ops = [
        lambda a: a.transpose(*hw),
        lambda a: a.flip(hw[0]),
        lambda a: a.flip(hw[1]),
    ]
    bits = (4, 2, 1)
    order = range(3) if not inverse else reversed(range(3))
    for i in order:
        x = torch.where((sb & bits[i]) != 0, ops[i](x), x)
    return x


def transform_planes_batch(x, syms):
    """Per-row symmetries on [B, H, W, C] planes; `syms` is [B] in [0, 8)."""
    return _spatial_transform_batch(x, syms, inverse=False)


def _policy_spatial_batch(p, syms, n: int, inverse: bool):
    b = p.shape[0]
    sp = _spatial_transform_batch(
        p[:, : n * n].reshape(b, n, n), syms, inverse
    ).reshape(b, n * n)
    if p.shape[-1] == n * n + 1:
        return torch.cat([sp, p[:, n * n :]], -1)
    return sp


def inverse_transform_policy_batch(p, syms, n: int):
    """Invert `transform_*_batch` on a flat spatial output [B, n*n(+1)]."""
    return _policy_spatial_batch(p, syms, n, inverse=True)


def inverse_transform_policy(p, sym: int, n: int):
    """Invert symmetry `sym` on a flat policy [..., n*n(+1)]."""
    spatial = p[..., : n * n].reshape(p.shape[:-1] + (n, n, 1))
    spatial = inverse_transform_planes(spatial, sym).reshape(p.shape[:-1] + (n * n,))
    if p.shape[-1] == n * n + 1:
        return torch.cat([spatial, p[..., n * n :]], -1)
    return spatial


_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 `a` in [0, 2**32) without int64
    overflow: split `a` into 16-bit halves."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def random_symmetries(states, seed: int = 0):
    """[B] int64 symmetry draw per query, a pure function of the position
    hash and side to move (bit-exact with the JAX package's uint32 mix)."""
    h = states.hash
    tm = states.to_move.to(torch.int64)
    mix = (
        _mul32(h[:, 0], 2654435761)
        ^ _mul32(h[:, 1], 2246822519)
        ^ ((seed * 3266489917) & _M32)
        ^ _mul32(tm, 668265263)
    )
    mix = mix ^ (mix >> 15)
    mix = _mul32(mix, 2246822519)
    return mix >> 29
