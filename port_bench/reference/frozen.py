"""Frozen plain rules of the measured program, copied into the harness.

These are verbatim copies of the plain (non-kernel) functions of
sayuri_tpu_torch at the commit that added this benchmark: the board
primitives and zobrist hash (game/board.py), Benson's pass-alive area
(game/analysis.py), the plain analysis and ladder-prep twins
(ops/analysis.py), the plain greedy and fork-stack ladder searches
(ops/ladder_kernel.py), the ladder planes (game/ladder.py) and the
position-hash symmetry draw (models/symmetry.py). Every call goes to the
plain version: no kernel, no import of the program. They are the
yardstick's rules: the midgame-root generator plays with them and the
reference checks the program's boards, encoder inputs and ladder planes
against them. A later change to the program does not change them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# ---- from sayuri_tpu_torch/game/types.py ----
BLACK = 0

WHITE = 1

EMPTY = 0

C_BLACK = 1

C_WHITE = 2

NO_VERTEX = -1

AREA_RULE = 0

TERRITORY_RULE = 1

# ---- from sayuri_tpu_torch/game/board.py ----
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

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))

_DIAGS = ((1, 1), (1, -1), (-1, 1), (-1, -1))

def nbr_or(m):
    """bool [..., n, n] -> True where ANY 4-neighbour is True."""
    out = shift(m, *_DIRS[0], False)
    for d in _DIRS[1:]:
        out = out | shift(m, *d, False)
    return out

def diag_count(m):
    """int64 [..., n, n]: number of True diagonal neighbours."""
    return sum(shift(m, *d, False).to(torch.int64) for d in _DIAGS)

def chain_labels_plain(stone_mask):
    """Label each 4-connected component of `stone_mask` by the min flat
    index of its cells; -1 off-component. int64 [..., n, n]. Label
    propagation with pointer jumping, one host sync per sweep."""
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

def flood_plain(seed, allowed):
    """Grow `seed` within `allowed` via 4-connectivity until fixpoint."""
    labels = chain_labels_plain(allowed)
    hit = scatter_any(seed & allowed, labels)
    return allowed & gather_roots(hit, labels)

def reach(color_mask, target_mask):
    """Cells of `color_mask` connected (through color_mask) to a cell
    4-adjacent to `target_mask` (Tromp-Taylor reach)."""
    flood_fn = flood_plain
    return flood_fn(color_mask & nbr_or(target_mask), color_mask)

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

def _expand(x, like_ndim):
    """[...] tensor -> [..., 1, 1] for broadcasting against boards."""
    x = torch.as_tensor(x)
    return x.view(x.shape + (1,) * (like_ndim - x.ndim))

def legal_moves(stones, size, to_move, ko):
    """[..., n*n] bool pseudo-legal mask (no suicide, respects simple ko;
    no superko). Both colours' chains are labelled in one call."""
    n = stones.shape[-1]
    mask = board_mask(size, n, stones.device)
    tm = _expand(to_move, stones.ndim).to(stones.device)
    empty = (stones == EMPTY) & mask
    own = (stones == (tm + 1)) & mask
    opp = (stones == (2 - tm)) & mask

    labels_fn = chain_labels_plain
    lbl_own, lbl_opp = labels_fn(torch.stack([own, opp]))
    libs_own = chain_liberty_map(own, lbl_own, empty)
    libs_opp = chain_liberty_map(opp, lbl_opp, empty)

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
    flood_fn = flood_plain
    own_group = flood_fn(v_mask, own2)
    group_size = own_group.flatten(-2).sum(-1)
    group_libs = (nbr_or(own_group) & empty2).flatten(-2).sum(-1)

    is_ko = (n_cap == 1) & (group_size == 1) & (group_libs == 1)
    cap_v = captured.flatten(-2).to(torch.int64).argmax(-1)
    new_ko = torch.where(is_ko, cap_v, NO_VERTEX)
    return stones2, n_cap, new_ko

def area_ownership(stones, size):
    """[..., n, n] int64 in {-1, 0, +1}: Tromp-Taylor area ownership. Both
    colours' reach floods run in one call."""
    n = stones.shape[-1]
    mask = board_mask(size, n, stones.device)
    b = (stones == C_BLACK) & mask
    w = (stones == C_WHITE) & mask
    empty = (stones == EMPTY) & mask
    flood_fn = flood_plain
    reach_b, reach_w = flood_fn(
        torch.stack([empty & nbr_or(b), empty & nbr_or(w)]),
        torch.stack([empty, empty]),
    )
    i64 = torch.int64
    return (
        b.to(i64) - w.to(i64)
        + (reach_b & ~reach_w).to(i64) - (reach_w & ~reach_b).to(i64)
    )

@functools.lru_cache(maxsize=None)
def zobrist_numpy(n: int):
    """(cells [2, 3, n*n] uint32, stm [2, 2] uint32): the JAX package's
    generator and seed, so hashes agree bit for bit."""
    rng = np.random.Generator(np.random.Philox(key=0x5A9E12))
    cells = rng.integers(0, 2**32, size=(2, 3, n * n), dtype=np.uint32)
    cells[:, EMPTY, :] = 0  # empty contributes nothing
    stm = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint32)
    return cells, stm

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
    cells = torch.from_numpy(zobrist_numpy(n)[0].astype(np.int64)).to(stones.device)          # [2, 3, nn]
    flat = stones.flatten(-2).to(torch.int64).unsqueeze(-2)  # [..., 1, nn]
    vals = torch.where(flat == C_BLACK, cells[:, C_BLACK], 0) ^ torch.where(
        flat == C_WHITE, cells[:, C_WHITE], 0
    )                                                      # [..., 2, nn]
    return xor_reduce(vals, -1)

# ---- from sayuri_tpu_torch/game/analysis.py ----
INNER_SLOTS = 6

def _scatter_add(vals, labels, nn):
    """[B, nn] int64 sum of `vals` per label root."""
    idx = torch.where(labels >= 0, labels, nn).reshape(labels.shape[0], -1)
    out = torch.zeros(idx.shape[0], nn + 1, dtype=torch.int64, device=idx.device)
    out.scatter_add_(1, idx, vals.reshape(idx.shape).to(torch.int64))
    return out[:, :nn]

def _scatter_min(vals, labels, nn, fill):
    idx = torch.where(labels >= 0, labels, nn).reshape(labels.shape[0], -1)
    out = torch.full((idx.shape[0], nn + 1), fill, dtype=torch.int64,
                     device=idx.device)
    out.scatter_reduce_(1, idx, vals.reshape(idx.shape).to(torch.int64), "amin")
    return out[:, :nn]

def pass_alive_area(stones, size, color: int):
    """[B, n, n] bool: `color`'s pass-alive strings + vital regions +
    pass-dead opponent regions (Board::ComputePassAliveArea semantics)."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    dev = stones.device
    mask = board_mask(size, n, dev).expand(b, n, n)
    own = (stones == color + 1) & mask
    other = mask & ~own                      # empty or opponent cells
    empty_real = (stones == EMPTY) & mask
    opp_real = (stones == 2 - color) & mask

    lbl_r = chain_labels_plain(other)      # regions of non-color cells
    lbl_c = chain_labels_plain(own)        # my chains
    flat = flat_iota(n, dev).expand(b, n, n)

    # --- potential vitality: every empty cell of the region touches my
    # color; opponent stones are auto-vital under no-suicide ---
    cell_ok = torch.where(empty_real, nbr_or(own), True)
    potential = ~scatter_any(other & ~cell_ok, lbl_r)   # [B, nn]

    # --- candidate vital chains: <=4 chains around the region's min empty ---
    root_empty = _scatter_min(torch.where(empty_real, flat, nn), lbl_r, nn, nn)
    nbrA = neighbor_labels(lbl_c)          # [B, 4, n, n]
    nbrA = torch.where(empty_real[:, None], nbrA, -1)
    nbrA = torch.where(dedup_dir_mask(nbrA), nbrA, -1)
    nbrA_flat = nbrA.reshape(b, 4, nn)
    safe_root = root_empty.clamp(0, nn - 1)
    cand = torch.where(
        (root_empty < nn)[:, None],
        nbrA_flat.gather(2, safe_root[:, None].expand(b, 4, nn)),
        -1,
    )                                        # [B, 4, nn] per region root

    # --- vitality per (region, slot): every empty cell of the region is
    # adjacent to that chain ---
    cand_at_cell = cand.gather(
        2, lbl_r.clamp(min=0).reshape(b, 1, nn).expand(b, 4, nn)
    ).reshape(b, 4, n, n)
    vital = []
    for i in range(4):
        ci = cand_at_cell[:, i : i + 1]
        member = ((nbrA == ci).any(1)) & (ci[:, 0] >= 0)
        vital.append(
            potential & (cand[:, i] >= 0)
            & ~scatter_any(empty_real & ~member, lbl_r)
        )

    # --- Benson iteration over per-chain alive bits ---
    alive = scatter_any(own, lbl_c)      # all chains start alive

    def usable_of(alive):
        alive_cell = gather_roots(alive, lbl_c) & own
        dead_adj = nbr_or(own & ~alive_cell)
        return ~scatter_any(other & dead_adj, lbl_r), alive_cell

    while True:
        usable, _ = usable_of(alive)
        count = torch.zeros(b, nn + 1, dtype=torch.int64, device=dev)
        for i in range(4):
            flag = vital[i] & usable
            count.scatter_add_(1, torch.where(flag, cand[:, i], nn),
                               flag.to(torch.int64))
        alive2 = alive & (count[:, :nn] >= 2)
        if torch.equal(alive2, alive):
            break
        alive = alive2

    usable, alive_cells = usable_of(alive)
    vital_cells = other & gather_roots(potential & usable, lbl_r)

    # --- pass-dead opponent regions ---
    blockers = alive_cells | vital_cells
    others2 = mask & ~blockers
    lbl_r2 = chain_labels_plain(others2)

    no_c_side = ~nbr_or(blockers)
    corner_c = diag_count(blockers)
    interior = diag_count(mask) == 4
    corner_ok = torch.where(interior, corner_c <= 1, corner_c == 0)
    cand_eye = others2 & ~opp_real & no_c_side
    is_eye = cand_eye & corner_ok

    # --- inner-region refinement: a corner cell in a blocker component
    # that cannot reach the board edge outside the region counts as the
    # region owner (false-eye life). At most INNER_SLOTS regions per board,
    # in flat-index order of their roots.
    edge = mask & ~(
        shift(mask, 1, 0, False) & shift(mask, -1, 0, False)
        & shift(mask, 0, 1, False) & shift(mask, 0, -1, False)
    )
    border_blockers = flood_plain(blockers & edge, blockers)
    corner_maybe = diag_count(blockers & ~border_blockers)
    rescuable = cand_eye & ~corner_ok & torch.where(
        interior, corner_c - corner_maybe <= 1, corner_c == corner_maybe
    )
    need_region = scatter_any(rescuable, lbl_r2)         # [B, nn]
    if need_region.any():
        keyed = torch.where(need_region, torch.arange(nn, device=dev), nn)
        roots = torch.sort(keyed, dim=1).values[:, :INNER_SLOTS]  # [B, K]
        slot_root = torch.where(roots < nn, roots, -1)
        in_region = (lbl_r2[:, None] == slot_root[:, :, None, None]) & (
            slot_root >= 0
        )[:, :, None, None]                                  # [B, K, n, n]
        allowed = mask[:, None] & ~in_region
        outer = flood_plain(allowed & edge[:, None], allowed)
        inner = allowed & ~outer
        cc = diag_count(blockers[:, None] & ~inner)
        ok2 = torch.where(interior[:, None], cc <= 1, cc == 0)
        refined = cand_eye[:, None] & in_region & ok2
        is_eye = is_eye | refined.any(1)

    eye_count = _scatter_add(is_eye, lbl_r2, nn)
    same_reg_adj_eye = torch.zeros_like(is_eye)
    for d in _DIRS:
        same_reg_adj_eye |= shift(is_eye, *d, False) & (
            shift(lbl_r2, *d, -1) == lbl_r2
        )
    adj_flag = scatter_any(is_eye & same_reg_adj_eye, lbl_r2)
    eff_eyes = eye_count - ((eye_count == 2) & adj_flag).to(torch.int64)
    pass_dead_cells = others2 & gather_roots(eff_eyes < 2, lbl_r2)

    return alive_cells | vital_cells | pass_dead_cells

def safe_and_ownership(stones, size):
    """(safe [B,n,n] bool, ownership [B,n,n] int64): both colors'
    pass-alive areas computed once and shared between the safe area and
    the score-area ownership."""
    pa_b = pass_alive_area(stones, size, 0)
    pa_w = pass_alive_area(stones, size, 1)
    own = area_ownership(stones, size)
    own = torch.where(pa_b, 1, own)
    own = torch.where(pa_w, -1, own)
    return pa_b | pa_w, own

# ---- from sayuri_tpu_torch/ops/analysis.py ----
_NUM_LIBS = 5

def board_analysis_plain(stones, size, ko, to_move):
    """Plain PyTorch version of the analysis kernel. [B, n, n] int8 stones,
    [B] int32 size/ko/to_move -> dict(legal [B, nn] bool, libs, ownership,
    score_ownership [B, n, n] int32, safe [B, n, n] bool)."""
    n = stones.shape[-1]
    mask = board_mask(size, n, stones.device)
    empty = (stones == 0) & mask
    libs = torch.zeros(stones.shape, dtype=torch.int64, device=stones.device)
    for c in (C_BLACK, C_WHITE):
        m = (stones == c) & mask
        libs = libs + chain_liberty_map(m, chain_labels_plain(m), empty)
    safe, sown = safe_and_ownership(stones, size)
    return {
        "legal": legal_moves(stones, size, to_move, ko),
        "libs": libs.clamp(max=_NUM_LIBS).to(torch.int32),
        "ownership": area_ownership(stones, size).to(torch.int32),
        "safe": safe,
        "score_ownership": sown.to(torch.int32),
    }

def _chain_lib_vertices(labels, empty):
    """Per-chain-root first and second liberty vertex ([B, nn] int64 each,
    nn where absent): scatter-min of the adjacent empty cells into roots."""
    n = labels.shape[-1]
    nn = n * n
    b = labels.shape[0]
    nbr = torch.where(empty[:, None], neighbor_labels(labels), -1)
    tgt = torch.where(nbr >= 0, nbr, nn).reshape(b, 4 * nn)
    cell = flat_iota(n, labels.device).reshape(1, 1, nn).expand(b, 4, nn)
    cell = cell.reshape(b, 4 * nn)
    init = torch.full((b, nn + 1), nn, dtype=torch.int64, device=labels.device)
    lib1 = init.scatter_reduce(1, tgt, cell, "amin")
    tgt2 = torch.where(cell == lib1.gather(1, tgt), nn, tgt)
    lib2 = init.scatter_reduce(1, tgt2, cell, "amin")
    return lib1[:, :nn], lib2[:, :nn]

def ladder_prep_plain(stones, size, ko):
    """Plain PyTorch version of the ladder prep kernel. [B, n, n] int8
    stones, [B] int32 size/ko -> dict of [B, nn] maps: labels int32 (chain
    root = smallest flat index, -1 off a chain), nlibs int32 (the chain's
    liberties capped at 3, 0 off a chain), lib1/lib2 int32 (the chain's
    first/second liberty vertex, nn when absent or off a chain),
    legal_black/legal_white bool (IsLegalMove of one vertex: empty, not
    the ko vertex, and an empty neighbour, an own neighbour chain with >= 2
    liberties or an opponent neighbour chain in atari)."""
    n = stones.shape[-1]
    nn = n * n
    b = stones.shape[0]
    mask = board_mask(size, n, stones.device)
    empty = (stones == 0) & mask
    black = (stones == C_BLACK) & mask
    white = (stones == C_WHITE) & mask
    lbl_b, lbl_w = chain_labels_plain(black), chain_labels_plain(white)
    labels = torch.where(lbl_b >= 0, lbl_b, lbl_w)
    libs = (chain_liberty_map(black, lbl_b, empty)
            + chain_liberty_map(white, lbl_w, empty))
    lib1, lib2 = _chain_lib_vertices(labels, empty)
    flat_lbl = labels.reshape(b, nn)
    stone = flat_lbl >= 0
    root = flat_lbl.clamp(min=0)
    not_ko = flat_iota(n, stones.device) != ko.to(torch.int64)[:, None, None]
    base = empty & not_ko
    emp_nb = nbr_or(empty)

    def legal(own, opp):
        ok = emp_nb | nbr_or(own & (libs >= 2)) | nbr_or(opp & (libs == 1))
        return (base & ok).reshape(b, nn)

    i32 = torch.int32
    return {
        "labels": flat_lbl.to(i32),
        "nlibs": libs.clamp(max=3).reshape(b, nn).to(i32),
        "lib1": torch.where(stone, lib1.gather(1, root), nn).to(i32),
        "lib2": torch.where(stone, lib2.gather(1, root), nn).to(i32),
        "legal_black": legal(black, white),
        "legal_white": legal(white, black),
    }

# ---- from sayuri_tpu_torch/ops/ladder_kernel.py ----
DESCEND, RETURN = 0, 1

ROWS = 32

MAX_FORKS = 56

MAX_ALTS = 4

NODE_CAP = 2000

BIGI = 10**9

UNDECIDED = 0

PREY_GOOD = 1

HUNTER_GOOD = 2

def pack_bitboards(mask):
    """[B, n, n] bool -> [B, ROWS] int32 row words (bit x of word y)."""
    n = mask.shape[-1]
    bits = mask.to(torch.int64) << torch.arange(n, device=mask.device)
    words = bits.sum(-1)                                     # [B, n]
    pad = torch.zeros(mask.shape[:-2] + (ROWS - n,), dtype=torch.int64,
                      device=mask.device)
    return torch.cat([words, pad], -1).to(torch.int32)

def _popc(x):
    """Per-element popcount of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24

def _popcount(b):
    """[L] total bits per lane."""
    return _popc(b).sum(-1)

def _roll(b, shift):
    return torch.roll(b, shift, dims=-1)

def _nbr(b, colmask):
    """OR of the 4 neighbours; `colmask` ([L, 1]) drops bits >= size."""
    return ((b << 1) & colmask) | (b >> 1) | _roll(b, 1) | _roll(b, ROWS - 1)

def _flood_conv(seed, allowed, colmask):
    """Grow `seed` within `allowed` until no lane grows."""
    x = seed & allowed
    while True:
        x2 = (x | _nbr(x, colmask)) & allowed
        if torch.equal(x2, x):
            return x
        x = x2

def _lowest_vertex(b, n):
    """[L] smallest flat vertex (row * n + bit) set in each lane, BIGI when
    the lane is empty."""
    low = b & -b
    pos = _popc(torch.where(b != 0, low - 1, 0))
    rows = torch.arange(ROWS, device=b.device)
    vert = torch.where(b != 0, rows * n + pos, BIGI)
    return vert.min(-1).values

def _vertex_bit(v, n):
    """[L, ROWS] one-hot board of flat vertex `v` ([L]); v < 0 or
    v >= n*n (BIGI included) -> empty board."""
    rows = torch.arange(ROWS, device=v.device)
    r = torch.div(v, n, rounding_mode="floor")
    c = (v - r * n).clamp(0, 31)
    bit = torch.ones_like(c) << c
    hit = (rows == r[:, None]) & ((v >= 0) & (v < n * n))[:, None]
    return torch.where(hit, bit[:, None], 0)

def _dir_seeds(bit, colmask):
    """The 4 single-bit neighbours of a one-hot board (E, W, S, N)."""
    return ((bit << 1) & colmask, bit >> 1, _roll(bit, 1), _roll(bit, ROWS - 1))

def _chain_queries(vbit, own, opp, empty, colmask):
    """Liberty/atari facts of the <= 4 own and <= 4 opp chains next to a
    vertex (GetLadderLiberties, board.cc:483-517), both colours at once."""
    zero = torch.zeros(vbit.shape[0], dtype=torch.int64, device=vbit.device)
    q = dict(conn=zero, maxconn=zero, own_safe=zero > 0, own_atari=zero > 0,
             ncaps=zero, potential=zero, opp_safe=zero > 0)
    own_prev = torch.zeros_like(vbit)
    opp_prev = torch.zeros_like(vbit)
    for seed in _dir_seeds(vbit, colmask):
        so = seed & own
        dup = _popcount(so & own_prev) > 0
        ch = _flood_conv(so, own, colmask)
        libs = _popcount(_nbr(ch, colmask) & empty)
        has = (_popcount(so) > 0) & ~dup
        q["conn"] = q["conn"] + torch.where(has, libs - 1, 0)
        q["maxconn"] = torch.maximum(q["maxconn"], torch.where(has, libs - 1, 0))
        q["own_safe"] = q["own_safe"] | (has & (libs >= 2))
        q["own_atari"] = q["own_atari"] | (has & (libs == 1))
        own_prev = own_prev | ch

        sp = seed & opp
        dup = _popcount(sp & opp_prev) > 0
        ch = _flood_conv(sp, opp, colmask)
        libs = _popcount(_nbr(ch, colmask) & empty)
        has = (_popcount(sp) > 0) & ~dup
        atari = has & (libs == 1)
        q["ncaps"] = q["ncaps"] + atari.to(torch.int64)
        q["potential"] = q["potential"] + torch.where(atari, _popcount(ch), 0)
        q["opp_safe"] = q["opp_safe"] | (has & (libs >= 2))
        opp_prev = opp_prev | ch
    return q

def _adjacent_atari_union(bit, stones, empty, colmask):
    """Union of the `stones` chains next to `bit` that have exactly one
    liberty (playing `bit` captures them)."""
    prev = torch.zeros_like(bit)
    union = torch.zeros_like(bit)
    for seed in _dir_seeds(bit, colmask):
        s = seed & stones
        dup = _popcount(s & prev) > 0
        ch = _flood_conv(s, stones, colmask)
        libs = _popcount(_nbr(ch, colmask) & empty)
        atari = (_popcount(s) > 0) & ~dup & (libs == 1)
        union = union | torch.where(atari[:, None], ch, 0)
        prev = prev | ch
    return union

def _place_stone(bit, mover, other, empty, colmask, n):
    """Play `bit` for the mover: captures and simple ko (one stone taken by
    a lone stone left with one liberty). Returns (mover2, other2, ko)."""
    captured = _adjacent_atari_union(bit, other, empty, colmask)
    mover2 = mover | bit
    other2 = other & ~captured
    empty2 = (empty & ~bit) | (captured & ~bit)
    ncap = _popcount(captured)
    single = _popcount(bit & _nbr(mover2 & ~bit, colmask)) == 0
    mlibs = _popcount(_nbr(bit, colmask) & empty2)
    ko = torch.where((ncap == 1) & single & (mlibs == 1),
                     _lowest_vertex(captured, n), -1)
    return mover2, other2, ko

def _step_select(n, colmask, full, own, opp, prey, ko, pend_v, pend_prey):
    """One ply: apply the pending move, then the next side's selections
    and terminal test (sayuri_tpu/ops/ladder_kernel.py _step_select)."""
    has_move = pend_v >= 0
    hm = has_move[:, None]
    pp = pend_prey[:, None]
    mbit = _vertex_bit(pend_v, n)
    empty = full & ~own & ~opp
    mover2, other2, ko_new = _place_stone(
        mbit, torch.where(pp, own, opp), torch.where(pp, opp, own), empty,
        colmask, n)
    own1 = torch.where(hm, torch.where(pp, mover2, other2), own)
    opp1 = torch.where(hm, torch.where(pp, other2, mover2), opp)
    ko1 = torch.where(has_move, ko_new, ko)
    prey1 = _flood_conv(prey & own1, own1, colmask)
    empty1 = full & ~own1 & ~opp1

    selector_prey = ~pend_prey          # the prey answers a hunter move
    think_ko = has_move & selector_prey

    prey_libs = _nbr(prey1, colmask) & empty1
    nlibs = _popcount(prey_libs)
    l1 = _lowest_vertex(prey_libs, n)
    l1bit = _vertex_bit(l1, n)
    l2 = _lowest_vertex(prey_libs & ~l1bit, n)
    l2bit = _vertex_bit(l2, n)
    q1 = _chain_queries(l1bit, own1, opp1, empty1, colmask)
    q2 = _chain_queries(l2bit, own1, opp1, empty1, colmask)
    p1 = _popcount(_nbr(l1bit, colmask) & empty1)
    p2 = _popcount(_nbr(l2bit, colmask) & empty1)

    # ---- PreySelections (board.cc:519-573) ----
    escape_legal = (nlibs == 1) & (l1 != ko1) & (
        (p1 > 0) | q1["own_safe"] | (q1["ncaps"] > 0))
    # capture moves: peel <= 4 hunter chains next to the prey, after
    # dropping chains with a stone that has two empty neighbours
    e_e = (empty1 << 1) & colmask
    e_w = empty1 >> 1
    e_s = _roll(empty1, 1)
    e_n = _roll(empty1, ROWS - 1)
    two_empty = ((e_e & e_w) | (e_e & e_s) | (e_e & e_n)
                 | (e_w & e_s) | (e_w & e_n) | (e_s & e_n))
    not_atari = _flood_conv(two_empty & opp1, opp1, colmask)
    a = _nbr(prey1, colmask) & opp1 & ~not_atari
    cap_vs = []
    for _ in range(4):
        v0 = _lowest_vertex(a, n)
        ch = _flood_conv(_vertex_bit(v0, n), opp1, colmask)
        libs_mask = _nbr(ch, colmask) & empty1
        is_atari = (v0 < BIGI) & (_popcount(libs_mask) == 1)
        cap_vs.append(torch.where(is_atari, _lowest_vertex(libs_mask, n), BIGI))
        a = a & ~ch
    sel_v = [torch.where(escape_legal, l1, BIGI)]
    sel_ok = [escape_legal]
    for i, cv in enumerate(cap_vs):
        dup = cv == l1
        for prev in cap_vs[:i]:
            dup = dup | (cv == prev)
        sel_v.append(cv)
        sel_ok.append((cv < BIGI) & (cv != ko1) & ~dup)
    kp = sum(o.to(torch.int64) for o in sel_ok)
    lower = q1["ncaps"] + torch.maximum(p1, q1["maxconn"])
    upper = p1 + q1["potential"] + q1["conn"]
    prey_term = torch.where(
        (nlibs >= 2) | (think_ko & (ko1 >= 0)), PREY_GOOD,
        torch.where(kp == 0, HUNTER_GOOD,
                    torch.where(escape_legal & (lower >= 3), PREY_GOOD,
                                torch.where(escape_legal & (kp == 1) & (upper == 1),
                                            HUNTER_GOOD, UNDECIDED))))

    # ---- HunterSelections (board.cc:575-644) ----
    adjacent = _popcount(_nbr(l1bit, colmask) & l2bit) > 0
    legal1 = (l1 < BIGI) & (l1 != ko1) & ((p1 > 0) | q1["opp_safe"] | q1["own_atari"])
    legal2 = (l2 < BIGI) & (l2 != ko1) & ((p2 > 0) | q2["opp_safe"] | q2["own_atari"])
    both_open = ~adjacent & (p1 >= 3) & (p2 >= 3)
    h_ok1 = ((adjacent & (l1 < BIGI)) | (~adjacent & legal1 & (p2 < 3))) & ~both_open
    h_ok2 = ((adjacent & (l2 < BIGI)) | (~adjacent & legal2 & (p1 < 3))) & ~both_open
    kh = h_ok1.to(torch.int64) + h_ok2.to(torch.int64)
    hunter_term = torch.where(
        nlibs >= 3, PREY_GOOD,
        torch.where(nlibs <= 1, HUNTER_GOOD,
                    torch.where(both_open | (kh == 0), PREY_GOOD, UNDECIDED)))

    # ---- merge by selector side; first valid slot + up to 4 alternatives
    term = torch.where(selector_prey, prey_term, hunter_term)
    false = torch.zeros_like(selector_prey)
    zero = torch.zeros_like(l1)
    ok = [torch.where(selector_prey, sel_ok[i],
                      h_ok1 if i == 0 else (h_ok2 if i == 1 else false))
          for i in range(5)]
    vals = [torch.where(selector_prey, sel_v[i],
                        l1 if i == 0 else (l2 if i == 1 else zero))
            for i in range(5)]
    first_v = torch.full_like(l1, -1)
    rank = torch.zeros_like(l1)
    alts = [torch.full_like(l1, -1) for _ in range(MAX_ALTS)]
    for i in range(5):
        first_v = torch.where(ok[i] & (rank == 0), vals[i], first_v)
        for j in range(MAX_ALTS):
            alts[j] = torch.where(ok[i] & (rank == j + 1), vals[i], alts[j])
        rank = rank + ok[i].to(torch.int64)
    return dict(own1=own1, opp1=opp1, prey1=prey1, ko1=ko1,
                selector_prey=selector_prey, term=term, is_term=term != UNDECIDED,
                first_v=first_v, k=rank, alts=torch.stack(alts, -1))

def _lane_setup(own_words, opp_words, size, ko, prey_v, first_hunter_v, valid):
    """The valid lanes' initial state, int64: (lane index, colmask [V, 1],
    on-board rows [V, ROWS], own and opp rows, ko, prey_v, first_hunter_v)."""
    idx = (valid > 0).nonzero().flatten()
    sz = size[idx].to(torch.int64)
    colmask = ((torch.ones_like(sz) << sz) - 1)[:, None]
    rows = torch.arange(ROWS, device=idx.device)
    full = torch.where(rows < sz[:, None], colmask, 0)
    own = own_words[idx].to(torch.int64) & full
    opp = opp_words[idx].to(torch.int64) & full
    return idx, colmask, full, own, opp, ko[idx].to(torch.int64), \
        prey_v[idx].to(torch.int64), first_hunter_v[idx].to(torch.int64)

def greedy_steps_plain(own_words, opp_words, size, ko, prey_v, first_hunter_v,
                       valid, n, node_cap=NODE_CAP):
    """run_greedy_plain plus each lane's plies: (result [L] int32, forked
    [L] int32, steps [L] int64, the plies the lane ran, 0 where it is not
    valid)."""
    L = own_words.shape[0]
    dev = own_words.device
    result = torch.full((L,), PREY_GOOD, dtype=torch.int32, device=dev)
    forked = torch.zeros((L,), dtype=torch.int32, device=dev)
    steps = torch.zeros((L,), dtype=torch.int64, device=dev)
    idx, colmask, full, own, opp, ko_, pv, pend_v = _lane_setup(
        own_words, opp_words, size, ko, prey_v, first_hunter_v, valid)
    prey = _flood_conv(_vertex_bit(pv, n), own, colmask)
    pend_prey = torch.zeros_like(pend_v, dtype=torch.bool)
    nodes = torch.zeros_like(pend_v)
    fk = torch.zeros_like(pend_v, dtype=torch.bool)
    # every active lane takes one step per iteration; a finished lane leaves
    for _ in range(node_cap + 8):
        if idx.numel() == 0:
            break
        nodes = nodes + 1
        sel = _step_select(n, colmask, full, own, opp, prey, ko_, pend_v, pend_prey)
        freeze = nodes >= node_cap
        done = sel["is_term"] | freeze
        fk = fk | (~freeze & ~sel["is_term"] & (sel["k"] >= 2))
        res = torch.where(freeze, PREY_GOOD, sel["term"]).to(torch.int32)
        result[idx[done]] = res[done]
        forked[idx[done]] = fk[done].to(torch.int32)
        steps[idx[done]] = nodes[done]
        keep = ~done
        idx, colmask, full, nodes, fk = (x[keep] for x in (idx, colmask, full, nodes, fk))
        own, opp, prey = (sel[k][keep] for k in ("own1", "opp1", "prey1"))
        ko_, pend_v = sel["ko1"][keep], sel["first_v"][keep]
        pend_prey = sel["selector_prey"][keep]
    # lanes still undecided at the cap read PREY_GOOD
    forked[idx] = fk.to(torch.int32)
    steps[idx] = nodes
    return result, forked, steps

def run_greedy_plain(own_words, opp_words, size, ko, prey_v, first_hunter_v,
                     valid, n, node_cap=NODE_CAP):
    """Plain version of the greedy pass (sayuri_tpu/ops/ladder_kernel.py
    _greedy_machine). Returns (result [L] int32, forked [L] int32)."""
    return greedy_steps_plain(own_words, opp_words, size, ko, prey_v,
                              first_hunter_v, valid, n, node_cap)[:2]

def run_chases_plain(own_words, opp_words, size, ko, prey_v, first_hunter_v,
                     valid, n, node_cap=NODE_CAP, max_forks=MAX_FORKS):
    """Plain version of the exact fork-stack search (sayuri_tpu/ops/
    ladder_kernel.py _dfs_machine, gather form of the stack). Each
    iteration, a lane either DESCENDs one ply (apply the pending move,
    select, push a frame at a multi-selection point) or RETURNs one frame
    (propagate the subtree result, resume the next alternative or pop).
    Returns result [L] int32; lanes not valid read PREY_GOOD."""
    return chase_descents_plain(own_words, opp_words, size, ko, prey_v,
                                first_hunter_v, valid, n, node_cap, max_forks)[0]

def chase_descents_plain(own_words, opp_words, size, ko, prey_v, first_hunter_v,
                         valid, n, node_cap=NODE_CAP, max_forks=MAX_FORKS):
    """run_chases_plain plus each lane's descents: (result [L] int32,
    descents [L] int64, the plies the lane applied, 0 where it is not
    valid)."""
    L = own_words.shape[0]
    dev = own_words.device
    out = torch.full((L,), PREY_GOOD, dtype=torch.int32, device=dev)
    descents = torch.zeros((L,), dtype=torch.int64, device=dev)
    idx, colmask, full, own, opp, ko_, pv, pend_v = _lane_setup(
        own_words, opp_words, size, ko, prey_v, first_hunter_v, valid)
    V = idx.numel()
    if V == 0:
        return out, descents
    F = max_forks
    F1 = max(F, 1)          # stack arrays need one frame even when F is 0
    prey_bit = _vertex_bit(pv, n)
    prey = _flood_conv(prey_bit, own, colmask)
    i64 = dict(dtype=torch.int64, device=dev)
    pend_prey = torch.zeros(V, dtype=torch.bool, device=dev)
    mode = torch.full((V,), DESCEND, **i64)
    ret = torch.zeros(V, **i64)
    result = torch.full((V,), UNDECIDED, **i64)
    nodes = torch.zeros(V, **i64)
    sp = torch.zeros(V, **i64)
    st_own = torch.zeros((V, F1, ROWS), **i64)
    st_opp = torch.zeros_like(st_own)
    st_ko = torch.zeros((V, F1), **i64)
    st_alts = torch.zeros((V, F1, MAX_ALTS), **i64)
    st_cnt = torch.zeros_like(st_ko)
    st_idx = torch.zeros_like(st_ko)
    st_side = torch.zeros_like(st_ko, dtype=torch.bool)

    for _ in range(2 * node_cap + 16):
        active = result == UNDECIDED
        if not bool(active.any()):
            break
        d = (active & (mode == DESCEND)).nonzero().flatten()
        r = (active & (mode == RETURN)).nonzero().flatten()
        if d.numel():
            sel = _step_select(n, colmask[d], full[d], own[d], opp[d], prey[d],
                               ko_[d], pend_v[d], pend_prey[d])
            nodes1 = nodes[d] + 1
            is_term = sel["is_term"]
            need_push = ~is_term & (sel["k"] >= 2)
            freeze = (nodes1 >= node_cap) | (need_push & (sp[d] >= F))
            push = need_push & ~freeze
            p, sp_p = d[push], sp[d][push]
            st_own[p, sp_p] = sel["own1"][push]
            st_opp[p, sp_p] = sel["opp1"][push]
            st_ko[p, sp_p] = sel["ko1"][push]
            st_alts[p, sp_p] = sel["alts"][push]
            st_cnt[p, sp_p] = sel["k"][push] - 1
            st_idx[p, sp_p] = 0
            st_side[p, sp_p] = sel["selector_prey"][push]
            sp[d] = sp[d] + push.to(torch.int64)
            ret[d] = torch.where(is_term, sel["term"], ret[d])
            pend_v[d] = torch.where(is_term, pend_v[d], sel["first_v"])
            pend_prey[d] = torch.where(is_term, pend_prey[d], sel["selector_prey"])
            mode[d] = torch.where(is_term, RETURN, DESCEND)
            own[d], opp[d], prey[d] = sel["own1"], sel["opp1"], sel["prey1"]
            ko_[d] = sel["ko1"]
            nodes[d] = nodes1
            result[d] = torch.where(freeze, PREY_GOOD, result[d])
        if r.numel():
            sp_r = sp[r]
            empty = sp_r <= 0
            top = (sp_r - 1).clamp(0, F1 - 1)
            side = st_side[r, top]
            t_idx = st_idx[r, top]
            decided = torch.where(side, ret[r] == PREY_GOOD, ret[r] == HUNTER_GOOD)
            pop = decided | (t_idx >= st_cnt[r, top])
            resume = ~empty & ~pop
            rr, tr, ir = r[resume], top[resume], t_idx[resume]
            own[rr] = st_own[rr, tr]
            opp[rr] = st_opp[rr, tr]
            prey[rr] = _flood_conv(prey_bit[rr], own[rr], colmask[rr])
            ko_[rr] = st_ko[rr, tr]
            pend_v[rr] = st_alts[rr, tr, ir]
            pend_prey[rr] = side[resume]
            st_idx[rr, tr] = ir + 1
            sp[r] = torch.where(empty | ~pop, sp_r, sp_r - 1)
            mode[r] = torch.where(resume, DESCEND, RETURN)
            result[r] = torch.where(empty, ret[r], result[r])
    result = torch.where(result == UNDECIDED, PREY_GOOD, result)
    out[idx] = result.to(torch.int32)
    descents[idx] = nodes
    return out, descents

# ---- from sayuri_tpu_torch/game/ladder.py ----
def max_chains(n):
    """Candidate-chain slots per board. The reference searches every chain
    with 1 or 2 liberties; golden games show at most 17 (9x9) and 48
    (19x19), so n*n//4 slots (90 at 19x19) leave a margin."""
    return max(24, (n * n) // 4)

def _extract_candidates(prep, stones, M):
    """Top-M candidate roots (ascending) and their facts from the prep maps:
    dict(cand_v [B, M] (-1 = empty slot), l1, l2, nlibs, color (0 black,
    1 white prey), legal_a, legal_b (the hunter may play l1 / l2))."""
    b, nn = prep["labels"].shape
    iota = torch.arange(nn, device=stones.device)
    labels = prep["labels"]
    nlibs = prep["nlibs"]
    cand = (labels == iota) & ((nlibs == 1) | (nlibs == 2))
    first = torch.sort(torch.where(cand, iota, nn), dim=1).values[:, :M]
    cand_v = torch.where(first < nn, first, -1)
    root = cand_v.clamp(min=0)
    l1 = prep["lib1"].gather(1, root)
    l2 = prep["lib2"].gather(1, root)
    color = torch.where(stones.reshape(b, nn).gather(1, root) == C_BLACK, 0, 1)
    hunter_black = color == 1

    def hunter_legal(v):
        vs = v.clamp(max=nn - 1).to(torch.int64)
        leg = torch.where(hunter_black, prep["legal_black"].gather(1, vs),
                          prep["legal_white"].gather(1, vs))
        return leg & (v < nn)

    return dict(cand_v=cand_v, l1=l1, l2=l2, nlibs=nlibs.gather(1, root),
                color=color, legal_a=hunter_legal(l1), legal_b=hunter_legal(l2))

def chase_lanes(stones, size, ko):
    """Steps 1-2 on a batch: (prep maps, candidate dict, lane inputs, ok).
    The lane inputs are [L, ROWS] int32 own (prey colour) and opp words and
    [L] int32 size, ko, prey vertex and first hunter move, L = B *
    max_chains(n) * 2 (both lanes of a candidate alike); ok [L] bool marks
    the lanes to search."""
    b, n = stones.shape[0], stones.shape[-1]
    M = max_chains(n)
    prep = ladder_prep_plain(stones, size, ko)
    c = _extract_candidates(prep, stones, M)
    cand_v, nlibs, l1, l2 = c["cand_v"], c["nlibs"], c["l1"], c["l2"]
    valid = cand_v >= 0

    mask = board_mask(size, n)
    bwords = pack_bitboards((stones == C_BLACK) & mask)[:, None]   # [B, 1, 32]
    wwords = pack_bitboards((stones == C_WHITE) & mask)[:, None]
    prey_black = (c["color"] == 0)[..., None]
    own = torch.where(prey_black, bwords, wwords)                     # [B, M, 32]
    opp = torch.where(prey_black, wwords, bwords)
    fh0 = torch.where(nlibs == 1, NO_VERTEX, l1)
    ok0 = valid & ((nlibs == 1) | ((nlibs == 2) & c["legal_a"]))
    ok1 = valid & (nlibs == 2) & c["legal_b"]

    def lanes(x):
        """[B, M, ...] -> [B*M*2, ...], both lanes of a candidate alike."""
        return x[:, :, None].expand(b, M, 2, *x.shape[2:]).reshape(
            b * M * 2, *x.shape[2:]).contiguous()

    i32 = torch.int32
    args = (
        lanes(own), lanes(opp),
        lanes(size[:, None].expand(b, M)).to(i32),
        lanes(ko[:, None].expand(b, M)).to(i32),
        lanes(cand_v.clamp(min=0)).to(i32),
        torch.stack([fh0, l2], 2).reshape(-1).to(i32),
    )
    ok = torch.stack([ok0, ok1], 2).reshape(-1)
    return prep, c, args, ok

def ladder_planes_batch(stones, size, ko=None):
    """[B, n, n, 4] float32 ladder planes [death, escapable, atari, take]
    of a batch: [B, n, n] int8 stones, [B] int32 size and ko (None: no
    ko)."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    dev = stones.device
    if ko is None:
        ko = torch.full((b,), NO_VERTEX, dtype=torch.int32, device=dev)
    M = max_chains(n)
    prep, c, args, ok = chase_lanes(stones, size, ko)
    cand_v, nlibs, l1, l2 = c["cand_v"], c["nlibs"], c["l1"], c["l2"]
    valid = cand_v >= 0
    i32 = torch.int32
    res_g, forked = run_greedy_plain(*args, ok.to(i32), n)
    fv = (forked > 0) & ok
    res_d = run_chases_plain(*args, fv.to(i32), n)
    res = torch.where(fv, res_d, res_g).reshape(b, M, 2)

    died = (nlibs == 1) & valid & (res[..., 0] == HUNTER_GOOD)
    ok_ab = ok.reshape(b, M, 2)
    vital_a = (nlibs == 2) & ok_ab[..., 0] & (res[..., 0] == HUNTER_GOOD)
    vital_b = (nlibs == 2) & ok_ab[..., 1] & (res[..., 1] == HUNTER_GOOD)

    chain_of = (prep["labels"][:, None, :] == cand_v[..., None]) & valid[..., None]
    cells = torch.arange(nn, device=dev)
    oh_l1 = l1[..., None] == cells                 # nn (absent) hits no cell
    oh_l2 = l2[..., None] == cells
    death = (chain_of & died[..., None]).any(1)
    esc = (chain_of & (vital_a | vital_b)[..., None]).any(1)
    # vital-move marks: the last candidate (highest root) to mark a cell wins
    mark_take = oh_l1 & died[..., None]                               # [B, M, nn]
    mark_atari = (oh_l1 & vital_a[..., None]) | (oh_l2 & vital_b[..., None])
    m_iota = torch.arange(M, device=dev)[None, :, None]
    last = torch.where(mark_take | mark_atari, m_iota, -1).amax(1)    # [B, nn]
    win = m_iota == last[:, None, :]
    take = (mark_take & win).any(1)
    atari = (mark_atari & win).any(1)
    return torch.stack([death, esc, atari, take], -1).reshape(
        b, n, n, 4).to(torch.float32)

# ---- from sayuri_tpu_torch/models/symmetry.py ----
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
