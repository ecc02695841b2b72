"""Spatial pattern features around a candidate move (the port's own copy
of sayuri_tpu.pattern.pattern, which is numpy and pure Python).

The colored neighborhood of a candidate vertex within a distance-d
diamond, canonicalized over the 8 dihedral symmetries and color inversion
so equivalent shapes share one key. Host-side numpy (pattern training is
offline); ``gammas_device.py`` computes the same keys for a batch of
boards with tensors.
"""

from __future__ import annotations

import numpy as np

# diamond (Manhattan-ball) offsets per distance
def diamond_offsets(dist: int):
    out = []
    for dy in range(-dist, dist + 1):
        for dx in range(-dist, dist + 1):
            if abs(dy) + abs(dx) <= dist and not (dy == 0 and dx == 0):
                out.append((dy, dx))
    return out


_SYMS = [
    lambda y, x: (y, x),
    lambda y, x: (y, -x),
    lambda y, x: (-y, x),
    lambda y, x: (-y, -x),
    lambda y, x: (x, y),
    lambda y, x: (x, -y),
    lambda y, x: (-x, y),
    lambda y, x: (-x, -y),
]

# cell codes: 0 empty, 1 own, 2 opp, 3 off-board
def _cell_code(board: np.ndarray, size: int, y: int, x: int, to_move: int):
    if not (0 <= y < size and 0 <= x < size):
        return 3
    v = int(board[y, x])
    if v == 0:
        return 0
    color = v - 1
    return 1 if color == to_move else 2


def pattern_key(board: np.ndarray, size: int, vertex: int, to_move: int,
                dist: int = 3) -> int:
    """Canonical (min over 8 symmetries) base-4 packed neighborhood key.
    Own/opp relative coding makes the key color-symmetric, matching the
    reference's color-indexed tables (pattern.h)."""
    y0, x0 = divmod(vertex, size)
    offs = diamond_offsets(dist)
    best = None
    for sym in _SYMS:
        key = 0
        for dy, dx in offs:
            sy, sx = sym(dy, dx)
            key = key * 4 + _cell_code(board, size, y0 + sy, x0 + sx, to_move)
        if best is None or key < best:
            best = key
    return (best << 4) | dist


def chain_liberty_counts(board: np.ndarray, size: int):
    """[2, size, size] int: liberty count of the chain occupying each
    stone (index 0 = black chains, 1 = white). One BFS pass per board —
    the per-board precompute for `tactical_features` (the reference keeps
    the same data live on its pattern board, pattern_board.cc)."""
    libs = np.zeros((2, size, size), np.int32)
    seen = np.zeros((size, size), bool)
    b = np.asarray(board)[:size, :size]
    for y in range(size):
        for x in range(size):
            v = int(b[y, x])
            if v == 0 or seen[y, x]:
                continue
            stack = [(y, x)]
            seen[y, x] = True
            chain = []
            libset = set()
            while stack:
                cy, cx = stack.pop()
                chain.append((cy, cx))
                for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < size and 0 <= nx < size:
                        if int(b[ny, nx]) == v and not seen[ny, nx]:
                            seen[ny, nx] = True
                            stack.append((ny, nx))
                        elif int(b[ny, nx]) == 0:
                            libset.add((ny, nx))
            for cy, cx in chain:
                libs[v - 1, cy, cx] = len(libset)
    return libs


def tactical_features(board: np.ndarray, size: int, vertex: int,
                      to_move: int, last_move: int | None,
                      libs: np.ndarray | None = None):
    """Small tactical feature set (capture/atari/self-atari/proximity),
    the reference's board feature hashes (board.h:226-233) reduced to the
    load-bearing ones. Returns a list of string feature ids. Pass `libs`
    from `chain_liberty_counts` when scoring many vertices of one board."""
    feats = []
    y0, x0 = divmod(vertex, size)
    if last_move is not None and last_move >= 0:
        ly, lx = divmod(last_move, size)
        d = abs(ly - y0) + abs(lx - x0)
        if d <= 4:
            feats.append(f"dist_last:{d}")
    if libs is None:
        libs = chain_liberty_counts(board, size)
    b = np.asarray(board)
    for color, tag in ((to_move, "own"), (1 - to_move, "opp")):
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            yy, xx = y0 + dy, x0 + dx
            if 0 <= yy < size and 0 <= xx < size and b[yy, xx] == color + 1:
                l = int(libs[color, yy, xx])
                if l == 1:
                    feats.append(f"{tag}_atari_adjacent")
                elif l == 2:
                    feats.append(f"{tag}_2libs_adjacent")
    return sorted(set(feats))
