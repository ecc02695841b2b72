"""Dense-tensor Go board primitives (PyTorch port of sayuri_tpu.game.board).

The board is a plain ``[..., n, n]`` int8 grid and every rules question is
answered with masked neighbourhood operations on batched tensors (the JAX
package writes them for one board and ``vmap``s them; here every function
takes any number of leading batch dimensions):

- string identity      -> label propagation to the min flat index, sped up
                          by pointer jumping (`chain_labels`)
- string connectivity  -> "same label as a seed cell" (`flood`)
- exact liberty counts -> direction-deduped scatter-add over chain labels
                          (`chain_liberty_map`)
- captures             -> "reaches empty" reachability (Tromp-Taylor style)

``size`` is an int or a tensor of the leading shape: smaller boards live in
the top-left corner of the fixed ``n x n`` buffer with an on-board mask.
These are the plain versions behind the CUDA analysis kernels' CPU twins
(ops/analysis.py); nothing here launches a kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sayuri_tpu_torch.game.types import EMPTY, C_BLACK, C_WHITE, NO_VERTEX


# ---------------------------------------------------------------------------
# masks and shifts
# ---------------------------------------------------------------------------

def board_mask(size, n: int, device=None):
    """[..., n, n] bool: True on playable cells of a size x size board."""
    if isinstance(size, torch.Tensor):
        device = size.device
        s = size.to(torch.int64)[..., None, None]
    else:
        s = torch.tensor(int(size), device=device)
    r = torch.arange(n, device=device)
    return (r[:, None] < s) & (r[None, :] < s)


def flat_iota(n: int, device=None):
    """[n, n] int64 of flat row-major indices."""
    return torch.arange(n * n, device=device).view(n, n)


def shift(x, dy: int, dx: int, fill):
    """out[..., y, x] = x[..., y - dy, x - dx], `fill` outside (|d| <= 1)."""
    n = x.shape[-1]
    out = torch.full_like(x, fill)
    dst_y = slice(max(dy, 0), n + min(dy, 0))
    src_y = slice(max(-dy, 0), n + min(-dy, 0))
    dst_x = slice(max(dx, 0), n + min(dx, 0))
    src_x = slice(max(-dx, 0), n + min(-dx, 0))
    out[..., dst_y, dst_x] = x[..., src_y, src_x]
    return out


# neighbour order of the JAX package (_neighbor_labels): from the cell
# above, below, left, right
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_DIAGS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def nbr_or(m):
    """bool [..., n, n] -> True where ANY 4-neighbour is True."""
    out = shift(m, *_DIRS[0], False)
    for d in _DIRS[1:]:
        out = out | shift(m, *d, False)
    return out


def nbr_count(m):
    """int64 [..., n, n]: number of True 4-neighbours."""
    return sum(shift(m, *d, False).to(torch.int64) for d in _DIRS)


def diag_count(m):
    """int64 [..., n, n]: number of True diagonal neighbours."""
    return sum(shift(m, *d, False).to(torch.int64) for d in _DIAGS)


# ---------------------------------------------------------------------------
# connectivity
# ---------------------------------------------------------------------------

def chain_labels(stone_mask):
    """Label each 4-connected component of `stone_mask` by the min flat
    index of its cells; -1 off-component. int64 [..., n, n]."""
    n = stone_mask.shape[-1]
    nn = n * n
    lead = stone_mask.shape[:-2]
    m = stone_mask.reshape(-1, n, n)
    big = nn
    flat = flat_iota(n, m.device)
    lbl = torch.where(m, flat, big)
    pad = torch.full((m.shape[0], 1), big, dtype=torch.int64, device=m.device)
    while True:
        nb = lbl
        for d in _DIRS:
            nb = torch.minimum(nb, shift(lbl, *d, big))
        new = torch.where(m, nb, big).view(-1, nn)
        # pointer jumping: a label is a cell of the same component whose
        # own label is never larger
        new = torch.cat([new, pad], 1)
        new = new.gather(1, new[:, :nn]).view(-1, n, n)
        if torch.equal(new, lbl):
            break
        lbl = new
    return torch.where(m, lbl, -1).view(lead + (n, n))


def scatter_any(vals, labels):
    """[..., nn] bool: OR of `vals` per label root."""
    nn = labels.shape[-1] * labels.shape[-2]
    lead = labels.shape[:-2]
    idx = torch.where(labels >= 0, labels, nn).reshape(-1, nn)
    out = torch.zeros(idx.shape[0], nn + 1, dtype=torch.int64, device=idx.device)
    out.scatter_add_(1, idx, vals.reshape(-1, nn).to(torch.int64))
    return (out[:, :nn] > 0).view(lead + (nn,))


def gather_roots(per_root, labels):
    """Broadcast a per-root [..., nn] array back onto cells [..., n, n]."""
    n = labels.shape[-1]
    lead = labels.shape[:-2]
    idx = labels.clamp(min=0).reshape(-1, n * n)
    return per_root.reshape(-1, n * n).gather(1, idx).view(lead + (n, n))


def flood(seed, allowed):
    """Grow `seed` within `allowed` via 4-connectivity until fixpoint."""
    labels = chain_labels(allowed)
    hit = scatter_any(seed & allowed, labels)
    return allowed & gather_roots(hit, labels)


def reach(color_mask, target_mask):
    """Cells of `color_mask` connected (through color_mask) to a cell
    4-adjacent to `target_mask` (Tromp-Taylor reach)."""
    return flood(color_mask & nbr_or(target_mask), color_mask)


def neighbor_labels(labels):
    """[..., 4, n, n] labels of the 4 neighbours (-1 where none)."""
    return torch.stack([shift(labels, *d, -1) for d in _DIRS], dim=-3)


def dedup_dir_mask(nbr_lbl):
    """[..., 4, n, n] bool: direction d kept if its label >= 0 and differs
    from all labels at directions d' < d."""
    l0, l1, l2, l3 = nbr_lbl.unbind(-3)
    keep0 = l0 >= 0
    keep1 = (l1 >= 0) & (l1 != l0)
    keep2 = (l2 >= 0) & (l2 != l0) & (l2 != l1)
    keep3 = (l3 >= 0) & (l3 != l0) & (l3 != l1) & (l3 != l2)
    return torch.stack([keep0, keep1, keep2, keep3], dim=-3)


def chain_liberty_counts(labels, empty):
    """[..., n*n] int64: slot r = #distinct empty cells adjacent to the
    chain whose root is r (0 elsewhere)."""
    n = labels.shape[-1]
    nn = n * n
    lead = labels.shape[:-2]
    nbr = neighbor_labels(labels)
    nbr = torch.where(empty.unsqueeze(-3), nbr, -1)
    keep = dedup_dir_mask(nbr)
    idx = torch.where(keep, nbr, nn).reshape(-1, 4 * nn)
    counts = torch.zeros(idx.shape[0], nn + 1, dtype=torch.int64,
                         device=labels.device)
    counts.scatter_add_(1, idx, keep.reshape(-1, 4 * nn).to(torch.int64))
    return counts[:, :nn].view(lead + (nn,))


def chain_liberty_map(stone_mask, labels, empty):
    """[..., n, n] int64: liberty count of the chain each stone belongs to."""
    counts = chain_liberty_counts(labels, empty)
    return torch.where(stone_mask, gather_roots(counts, labels), 0)


# ---------------------------------------------------------------------------
# move legality and application
# ---------------------------------------------------------------------------

def _expand(x, like_ndim):
    """[...] tensor -> [..., 1, 1] for broadcasting against boards."""
    x = torch.as_tensor(x)
    return x.view(x.shape + (1,) * (like_ndim - x.ndim))


def legal_moves(stones, size, to_move, ko):
    """[..., n*n] bool pseudo-legal mask (no suicide, respects simple ko;
    no superko)."""
    n = stones.shape[-1]
    mask = board_mask(size, n, stones.device)
    tm = _expand(to_move, stones.ndim).to(stones.device)
    empty = (stones == EMPTY) & mask
    own = (stones == (tm + 1)) & mask
    opp = (stones == (2 - tm)) & mask

    libs_own = chain_liberty_map(own, chain_labels(own), empty)
    libs_opp = chain_liberty_map(opp, chain_labels(opp), empty)

    legal = empty & (
        nbr_or(empty) | nbr_or(own & (libs_own >= 2)) | nbr_or(opp & (libs_opp == 1))
    )
    legal = legal.flatten(-2)
    ko_t = torch.as_tensor(ko, device=stones.device)[..., None]
    return legal & (torch.arange(n * n, device=stones.device) != ko_t)


def play_move(stones, size, color, v):
    """Apply (assumed-legal) board moves; returns
    (new_stones, n_captured int64, new_ko int64) with the leading shape.

    Places the stone, removes opponent chains left without liberties, and
    sets the simple-ko vertex when exactly one stone was captured by a lone
    stone that ends in atari."""
    n = stones.shape[-1]
    nn = n * n
    dev = stones.device
    mask = board_mask(size, n, dev)
    col = _expand(color, stones.ndim).to(dev)
    own_c = (col + 1).to(stones.dtype)
    opp_c = (2 - col).to(stones.dtype)
    v = torch.as_tensor(v, device=dev).to(torch.int64)

    v_mask = (torch.arange(nn, device=dev) == v[..., None]).view(v.shape + (n, n))
    stones1 = torch.where(v_mask, own_c, stones)
    empty1 = (stones1 == EMPTY) & mask
    opp1 = (stones1 == opp_c) & mask

    captured = opp1 & ~reach(opp1, empty1)
    n_cap = captured.flatten(-2).sum(-1)
    stones2 = torch.where(captured, torch.zeros_like(stones1), stones1)

    own2 = (stones2 == own_c) & mask
    empty2 = (stones2 == EMPTY) & mask
    own_group = flood(v_mask, own2)
    group_size = own_group.flatten(-2).sum(-1)
    group_libs = (nbr_or(own_group) & empty2).flatten(-2).sum(-1)

    is_ko = (n_cap == 1) & (group_size == 1) & (group_libs == 1)
    cap_v = captured.flatten(-2).to(torch.int64).argmax(-1)
    new_ko = torch.where(is_ko, cap_v, NO_VERTEX)
    return stones2, n_cap, new_ko


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def area_ownership(stones, size):
    """[..., n, n] int64 in {-1, 0, +1}: Tromp-Taylor area ownership."""
    n = stones.shape[-1]
    mask = board_mask(size, n, stones.device)
    b = (stones == C_BLACK) & mask
    w = (stones == C_WHITE) & mask
    empty = (stones == EMPTY) & mask
    reach_b = flood(empty & nbr_or(b), empty)
    reach_w = flood(empty & nbr_or(w), empty)
    i64 = torch.int64
    return (
        b.to(i64) - w.to(i64)
        + (reach_b & ~reach_w).to(i64) - (reach_w & ~reach_b).to(i64)
    )


# ---------------------------------------------------------------------------
# zobrist hashing: 2 x 32-bit words held in int64 (values < 2**32), so that
# shifts and compares never meet torch's missing uint32 operators
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def zobrist_numpy(n: int):
    """(cells [2, 3, n*n] uint32, stm [2, 2] uint32): the JAX package's
    generator and seed, so hashes agree bit for bit."""
    rng = np.random.Generator(np.random.Philox(key=0x5A9E12))
    cells = rng.integers(0, 2**32, size=(2, 3, n * n), dtype=np.uint32)
    cells[:, EMPTY, :] = 0  # empty contributes nothing
    stm = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint32)
    return cells, stm


@functools.lru_cache(maxsize=None)
def _zobrist_cells(n: int, device: str):
    cells, _ = zobrist_numpy(n)
    return torch.from_numpy(cells.astype(np.int64)).to(device)


def xor_reduce(x, dim: int = -1):
    """XOR-reduce an integer tensor along `dim` (log fold)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        w = x.shape[-1]
        half = w // 2
        folded = x[..., :half] ^ x[..., half : 2 * half]
        x = torch.cat([folded, x[..., 2 * half :]], -1) if w % 2 else folded
    return x[..., 0]


def position_hash(stones):
    """[..., 2] int64 board-only hash (superko identity), 32 bits a word."""
    n = stones.shape[-1]
    cells = _zobrist_cells(n, str(stones.device))          # [2, 3, nn]
    flat = stones.flatten(-2).to(torch.int64).unsqueeze(-2)  # [..., 1, nn]
    vals = torch.where(flat == C_BLACK, cells[:, C_BLACK], 0) ^ torch.where(
        flat == C_WHITE, cells[:, C_WHITE], 0
    )                                                      # [..., 2, nn]
    return xor_reduce(vals, -1)
