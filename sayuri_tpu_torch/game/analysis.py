"""Batched board-safety analysis: Benson pass-alive, pass-dead, safe area
(PyTorch port of sayuri_tpu.game.analysis, same semantics cell for cell).

Regions and chains are min-index labels and every per-region / per-chain
aggregate is a scatter (add/or/min) over label roots:

- a region's candidate "vital" chains are the <=4 chains adjacent to its
  min-index empty cell;
- Benson's iteration ("remove strings with <2 vital regions; kill regions
  adjacent to removed strings") runs over per-chain alive bits until no
  board in the batch changes.

The pass-dead potential-eye count includes the "inner region" refinement
for false-eye life / two-headed dragons: at most INNER_SLOTS regions per
board get the exact border flood, and the overflow falls back to the
unrefined eye, as in the JAX package.

All functions take [B, n, n] int8 stones and a [B] (or int) size. This is
the plain twin of the analysis kernels, so it calls the plain fixpoints
(game/board.py ``chain_labels_plain``, ``flood_plain``) and launches no
kernel.
"""

from __future__ import annotations

import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.types import EMPTY

# exact inner-region refinements per board (pass-dead two-headed-dragon
# rescue); regions needing it beyond this fall back to the unrefined eye
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
    mask = B.board_mask(size, n, dev).expand(b, n, n)
    own = (stones == color + 1) & mask
    other = mask & ~own                      # empty or opponent cells
    empty_real = (stones == EMPTY) & mask
    opp_real = (stones == 2 - color) & mask

    lbl_r = B.chain_labels_plain(other)      # regions of non-color cells
    lbl_c = B.chain_labels_plain(own)        # my chains
    flat = B.flat_iota(n, dev).expand(b, n, n)

    # --- potential vitality: every empty cell of the region touches my
    # color; opponent stones are auto-vital under no-suicide ---
    cell_ok = torch.where(empty_real, B.nbr_or(own), True)
    potential = ~B.scatter_any(other & ~cell_ok, lbl_r)   # [B, nn]

    # --- candidate vital chains: <=4 chains around the region's min empty ---
    root_empty = _scatter_min(torch.where(empty_real, flat, nn), lbl_r, nn, nn)
    nbrA = B.neighbor_labels(lbl_c)          # [B, 4, n, n]
    nbrA = torch.where(empty_real[:, None], nbrA, -1)
    nbrA = torch.where(B.dedup_dir_mask(nbrA), nbrA, -1)
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
            & ~B.scatter_any(empty_real & ~member, lbl_r)
        )

    # --- Benson iteration over per-chain alive bits ---
    alive = B.scatter_any(own, lbl_c)      # all chains start alive

    def usable_of(alive):
        alive_cell = B.gather_roots(alive, lbl_c) & own
        dead_adj = B.nbr_or(own & ~alive_cell)
        return ~B.scatter_any(other & dead_adj, lbl_r), alive_cell

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
    vital_cells = other & B.gather_roots(potential & usable, lbl_r)

    # --- pass-dead opponent regions ---
    blockers = alive_cells | vital_cells
    others2 = mask & ~blockers
    lbl_r2 = B.chain_labels_plain(others2)

    no_c_side = ~B.nbr_or(blockers)
    corner_c = B.diag_count(blockers)
    interior = B.diag_count(mask) == 4
    corner_ok = torch.where(interior, corner_c <= 1, corner_c == 0)
    cand_eye = others2 & ~opp_real & no_c_side
    is_eye = cand_eye & corner_ok

    # --- inner-region refinement: a corner cell in a blocker component
    # that cannot reach the board edge outside the region counts as the
    # region owner (false-eye life). At most INNER_SLOTS regions per board,
    # in flat-index order of their roots.
    edge = mask & ~(
        B.shift(mask, 1, 0, False) & B.shift(mask, -1, 0, False)
        & B.shift(mask, 0, 1, False) & B.shift(mask, 0, -1, False)
    )
    border_blockers = B.flood_plain(blockers & edge, blockers)
    corner_maybe = B.diag_count(blockers & ~border_blockers)
    rescuable = cand_eye & ~corner_ok & torch.where(
        interior, corner_c - corner_maybe <= 1, corner_c == corner_maybe
    )
    need_region = B.scatter_any(rescuable, lbl_r2)         # [B, nn]
    if need_region.any():
        keyed = torch.where(need_region, torch.arange(nn, device=dev), nn)
        roots = torch.sort(keyed, dim=1).values[:, :INNER_SLOTS]  # [B, K]
        slot_root = torch.where(roots < nn, roots, -1)
        in_region = (lbl_r2[:, None] == slot_root[:, :, None, None]) & (
            slot_root >= 0
        )[:, :, None, None]                                  # [B, K, n, n]
        allowed = mask[:, None] & ~in_region
        outer = B.flood_plain(allowed & edge[:, None], allowed)
        inner = allowed & ~outer
        cc = B.diag_count(blockers[:, None] & ~inner)
        ok2 = torch.where(interior[:, None], cc <= 1, cc == 0)
        refined = cand_eye[:, None] & in_region & ok2
        is_eye = is_eye | refined.any(1)

    eye_count = _scatter_add(is_eye, lbl_r2, nn)
    same_reg_adj_eye = torch.zeros_like(is_eye)
    for d in B._DIRS:
        same_reg_adj_eye |= B.shift(is_eye, *d, False) & (
            B.shift(lbl_r2, *d, -1) == lbl_r2
        )
    adj_flag = B.scatter_any(is_eye & same_reg_adj_eye, lbl_r2)
    eff_eyes = eye_count - ((eye_count == 2) & adj_flag).to(torch.int64)
    pass_dead_cells = others2 & B.gather_roots(eff_eyes < 2, lbl_r2)

    return alive_cells | vital_cells | pass_dead_cells


def safe_and_ownership(stones, size):
    """(safe [B,n,n] bool, ownership [B,n,n] int64): both colors'
    pass-alive areas computed once and shared between the safe area and
    the score-area ownership."""
    pa_b = pass_alive_area(stones, size, 0)
    pa_w = pass_alive_area(stones, size, 1)
    own = B.area_ownership(stones, size, plain=True)
    own = torch.where(pa_b, 1, own)
    own = torch.where(pa_w, -1, own)
    return pa_b | pa_w, own


def score_area_ownership(stones, size):
    """[B, n, n] int64 {-1, 0, +1}: reach-area ownership overridden by each
    color's pass-alive area (area-rule score area). +1 black, -1 white."""
    return safe_and_ownership(stones, size)[1]
