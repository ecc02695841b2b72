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

All functions take [B, n, n] int8 stones and a [B] (or int) size. The
Benson functions are the plain twin of the analysis kernels, so they call
the plain fixpoints (game/board.py ``chain_labels_plain``, ``flood_plain``)
and launch no kernel. The territory helper's dead-stone removal
(``remove_dead_stones``) and its scoring (``score_area_ownership_territory``)
are on the self-play path: they label chains with ``chain_labels`` (the
labels kernel for CUDA tensors) and take the score area from
``ops.analysis.board_analysis`` (the analysis kernel for CUDA tensors, this
module's plain twin for CPU tensors).

Seki (``seki_points``, ``seki_at``, ``safe_area(mark_seki=True)``) serves
the GTP engine and the first-pass score bonus: both colours' chains are
labelled in one ``chain_labels`` call, and ``safe_area`` reads the safe
area from ``board_analysis``, so on the card no plain fixpoint runs.
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


def remove_dead_stones(stones, size, helper_own):
    """[B, n, n] int8 boards with helper-marked dead strings removed: every
    stone whose colour contradicts the territory-helper ownership
    `helper_own` ([B, n, n] in {-1, 0, +1}, black +1) marks its whole
    string, and marked strings are dropped. Both colours' chains are
    labelled in one ``chain_labels`` call."""
    n = stones.shape[-1]
    mask = B.board_mask(size, n, stones.device)
    black = (stones == 1) & mask
    white = (stones == 2) & mask
    colours = torch.stack([black, white])                 # [2, B, n, n]
    owner = torch.tensor([-1, 1], device=stones.device).view(2, 1, 1, 1)
    marked = colours & (helper_own.unsqueeze(0) == owner)
    lbl = B.chain_labels(colours)
    dead = B.gather_roots(B.scatter_any(marked, lbl), lbl) & colours
    return torch.where(dead.any(0), torch.zeros_like(stones), stones)


def score_ownership(stones, size):
    """[B, n, n] int32 score-area ownership (+1 black): the analysis
    kernel's for CUDA tensors, ``score_area_ownership`` for CPU tensors."""
    from sayuri_tpu_torch.ops.analysis import board_analysis

    b = stones.shape[0]
    size = torch.as_tensor(size, device=stones.device).to(torch.int32)
    size = size.expand(b).contiguous()
    z = torch.zeros(b, dtype=torch.int32, device=stones.device)
    return board_analysis(stones.contiguous(), size, z - 1, z)["score_ownership"]


def score_area_ownership_territory(stones, size, helper_own):
    """Territory-rule score area: remove helper-marked dead strings, then
    score the cleaned board under the area rule. [B, n, n] int32."""
    return score_ownership(remove_dead_stones(stones, size, helper_own), size)


# ---------------------------------------------------------------------------
# seki
# ---------------------------------------------------------------------------

def safe_area(stones, size, mark_seki: bool = False):
    """[B, n, n] bool: pass-alive / pass-dead area of either colour (the
    analysis kernel's ``safe`` map on the card, ``safe_and_ownership`` on
    the CPU); with `mark_seki`, the seki points are added."""
    from sayuri_tpu_torch.ops.analysis import board_analysis

    b = stones.shape[0]
    size = torch.as_tensor(size, device=stones.device).to(torch.int32).expand(b)
    z = torch.zeros(b, dtype=torch.int32, device=stones.device)
    out = board_analysis(stones.contiguous(), size.contiguous(), z - 1, z)["safe"]
    if mark_seki:
        out = out | seki_points(stones, size)
    return out


def _unique_neighbor_label(lbl, at_mask):
    """(label of the one distinct adjacent `lbl` chain where `at_mask`, else
    -1; True where more than one distinct chain is adjacent)."""
    nbr = B.neighbor_labels(lbl)                         # [B, 4, n, n]
    present = nbr >= 0
    big = torch.iinfo(torch.int64).max
    mn = torch.where(present, nbr, big).amin(-3)
    mx = torch.where(present, nbr, -1).amax(-3)
    one = (mx >= 0) & (mn == mx)
    return torch.where(at_mask & one, mx, -1), (mx >= 0) & (mn != mx)


def _scatter_reduce(vals, idx, nn, fill, reduce):
    """[B, nn] `reduce` ("amin" / "amax") of `vals` at label `idx` (>= 0;
    nn drops), starting from `fill`."""
    b = idx.shape[0]
    out = torch.full((b, nn + 1), fill, dtype=torch.int64, device=idx.device)
    out.scatter_reduce_(1, idx.reshape(b, -1), vals.reshape(b, -1).to(torch.int64),
                        reduce)
    return out[:, :nn]


def _chain_liberty_minmax(lbl, empty, nn):
    """(min, max) flat index of each chain's liberties, keyed by chain root
    ([B, nn] each). With exactly two liberties this is the liberty set."""
    nbr = B.neighbor_labels(lbl)                         # chains next to cells
    nbr = torch.where(empty.unsqueeze(-3), nbr, -1)      # liberties only
    n = lbl.shape[-1]
    cell = B.flat_iota(n, lbl.device).expand_as(nbr)
    idx = torch.where(nbr >= 0, nbr, nn)
    return (_scatter_reduce(cell, idx, nn, nn, "amin"),
            _scatter_reduce(cell, idx, nn, -1, "amax"))


def _at(per_root, idx):
    """per_root [B, nn] gathered at idx [B, ...] (clamped to the board)."""
    nn = per_root.shape[1]
    b = idx.shape[0]
    flat = idx.clamp(0, nn - 1).reshape(b, -1)
    return per_root.gather(1, flat).view(idx.shape)


def _seki_parts(stones, size):
    """Everything of the seki test except the per-candidate nakade analysis
    (seki_points runs that at every vertex, seki_at at one).

    An empty point v is seki iff exactly one black and one white chain are
    orthogonally adjacent, both have exactly two liberties, and either the
    chains do not share both liberties (a three-liberty union, false seki
    included), or neither chain is an inner chain (simple no-eye seki), or
    the inner chain + v forms an eye space the surrounder cannot kill by
    nakade (bent four in the corner, squared four, bulky five, rabbitty
    six and rectangular six in the corner are killable).

    Returns (seki, need, inner_lbl, inner_is_b, eye_size, ctx): [B, n, n]
    maps, and what ``_killable`` needs."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    dev = stones.device
    size = torch.as_tensor(size, device=dev).to(torch.int32).expand(b)
    mask = B.board_mask(size, n, dev)
    empty = (stones == EMPTY) & mask
    black = (stones == 1) & mask
    white = (stones == 2) & mask
    lbl_b, lbl_w = B.chain_labels(torch.stack([black, white]))

    # one adjacent chain of each colour
    ub, multi_b = _unique_neighbor_label(lbl_b, empty)
    uw, multi_w = _unique_neighbor_label(lbl_w, empty)
    cand = empty & (ub >= 0) & (uw >= 0) & ~multi_b & ~multi_w

    # both chains must have exactly two liberties
    libs_b = B.chain_liberty_counts(lbl_b, empty)
    libs_w = B.chain_liberty_counts(lbl_w, empty)
    cand = cand & (_at(libs_b, ub) == 2) & (_at(libs_w, uw) == 2)

    # liberty-union size: each chain's two liberties as (min, max) flat index
    bmin, bmax = _chain_liberty_minmax(lbl_b, empty, nn)
    wmin, wmax = _chain_liberty_minmax(lbl_w, empty, nn)
    shared_both = (_at(bmin, ub) == _at(wmin, uw)) & (_at(bmax, ub) == _at(wmax, uw))
    seki = cand & ~shared_both                           # 3-liberty union

    # inner chain: surrounded by exactly one opponent chain
    def sur_minmax(lbl_own, lbl_opp):
        nbr = B.neighbor_labels(lbl_opp)                 # opp chains at each cell
        own_cell = (lbl_own >= 0).unsqueeze(-3)
        val = torch.where(own_cell & (nbr >= 0), nbr, -1)
        idx = torch.where(val >= 0, lbl_own.clamp(min=0).unsqueeze(-3), nn)
        return (_scatter_reduce(torch.where(val >= 0, val, nn), idx, nn, nn, "amin"),
                _scatter_reduce(val, idx, nn, -1, "amax"))

    bsmin, bsmax = sur_minmax(lbl_b, lbl_w)
    wsmin, wsmax = sur_minmax(lbl_w, lbl_b)
    one_sur_b = (_at(bsmax, ub) >= 0) & (_at(bsmin, ub) == _at(bsmax, ub))
    one_sur_w = (_at(wsmax, uw) >= 0) & (_at(wsmin, uw) == _at(wsmax, uw))
    # black is checked first
    inner_is_b = one_sur_b
    no_inner = ~one_sur_b & ~one_sur_w
    seki = seki | (cand & shared_both & no_inner)        # simple no-eye seki

    # eye-space nakade analysis for the remaining candidates
    csize_b = _scatter_add(black, lbl_b, nn)
    csize_w = _scatter_add(white, lbl_w, nn)
    need = cand & shared_both & ~no_inner
    inner_lbl = torch.where(inner_is_b, ub, uw)
    eye_size = torch.where(inner_is_b, _at(csize_b, ub), _at(csize_w, uw)) + 1
    border = mask & ~(
        B.shift(mask, 1, 0, False) & B.shift(mask, -1, 0, False)
        & B.shift(mask, 0, 1, False) & B.shift(mask, 0, -1, False)
    )
    return seki, need, inner_lbl, inner_is_b, eye_size, (lbl_b, lbl_w, border)


def _killable(ctx, v_flat, lbl_v, is_b, esize):
    """Is the eye space of the inner chain `lbl_v` plus vertex `v_flat`
    killable by nakade? All four arguments are [B, K] (K candidates a
    board); returns [B, K] bool. Eye sizes up to 3 are always killable, 7
    and more never."""
    lbl_b, lbl_w, border = ctx
    n = lbl_b.shape[-1]
    nn = n * n
    flat = B.flat_iota(n, lbl_b.device)
    lblmap = torch.where(is_b[..., None, None], lbl_b[:, None], lbl_w[:, None])
    region = (lblmap == lbl_v[..., None, None]) & (lbl_v >= 0)[..., None, None]
    region = region | (flat == v_flat[..., None, None])   # [B, K, n, n]

    def cnt(m):
        return m.to(torch.int64)

    s_orth = sum(cnt(B.shift(region, *d, False)) for d in B._DIRS)
    d1, d2, d3, d4 = (cnt(B.shift(region, *d, False)) for d in B._DIAGS)
    s_diag = d1 + d2 + d3 + d4
    influence = s_orth + s_diag
    boundary_cnt = (region & border[:, None]).sum((-2, -1))
    nakade = region & (influence + 1 == esize[..., None, None]) & (s_diag >= 1)
    nakade_cnt = nakade.sum((-2, -1))
    # representative nakade: the min-flat-index one
    rep_flat = torch.where(nakade, flat, nn).amin((-2, -1))
    rep = nakade & (flat == rep_flat[..., None, None])
    eye_cnt = torch.where(rep, s_diag, 0).sum((-2, -1))
    side = (d1 * B.shift(s_orth, 1, 1, 0) + d2 * B.shift(s_orth, 1, -1, 0)
            + d3 * B.shift(s_orth, -1, 1, 0) + d4 * B.shift(s_orth, -1, -1, 0))
    side_of_eye = torch.where(rep, side, 0).sum((-2, -1))
    sq_kill = (eye_cnt == 1) & (side_of_eye == 2)
    k4 = (boundary_cnt == 4) | sq_kill                   # bent / squared four
    k5 = sq_kill                                         # bulky five
    k6 = ((nakade_cnt == 1) & sq_kill) | ((nakade_cnt == 2) & (boundary_cnt == 4))
    by_size = torch.where(esize == 4, k4, torch.where(esize == 5, k5, k6))
    return torch.where(
        esize <= 3, True,
        torch.where(esize >= 7, False, (nakade_cnt > 0) & by_size),
    )


def seki_points(stones, size):
    """[B, n, n] bool seki map; the nakade analysis runs at every vertex
    ([B, n*n, n, n] regions)."""
    b, n = stones.shape[0], stones.shape[-1]
    seki, need, inner_lbl, inner_is_b, eye_size, ctx = _seki_parts(stones, size)
    v = B.flat_iota(n, stones.device).reshape(1, -1).expand(b, -1)
    killable = _killable(ctx, v, inner_lbl.reshape(b, -1), inner_is_b.reshape(b, -1),
                         eye_size.reshape(b, -1)).view(b, n, n)
    return seki | (need & ~killable)


def seki_at(stones, size, v_flat):
    """[B] bool: is vertex `v_flat` ([B], clamped to the board) seki? One
    nakade analysis a board instead of n*n."""
    b, n = stones.shape[0], stones.shape[-1]
    seki, need, inner_lbl, inner_is_b, eye_size, ctx = _seki_parts(stones, size)
    v = torch.as_tensor(v_flat, device=stones.device).to(torch.int64)
    v = v.expand(b).clamp(0, n * n - 1)[:, None]           # [B, 1]

    def pick(m):
        return m.reshape(b, -1).gather(1, v)

    killable = _killable(ctx, v, pick(inner_lbl), pick(inner_is_b), pick(eye_size))
    return (pick(seki) | (pick(need) & ~killable))[:, 0]
