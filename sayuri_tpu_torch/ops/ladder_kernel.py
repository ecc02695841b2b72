"""Exact ladder chases (CUDA, csrc/ladder.cu) and their plain PyTorch twins.

Each chase is one LANE: a candidate chain (the prey, 1 or 2 liberties)
and the hunter's first move, on 32 row bitboards ([L, ROWS] int32 words,
bit x of row y is the cell (y, x)). The search is the reference's
hunter/prey AND-OR reader (PreySelections / HunterSelections, board.cc
520-821), written as an iterative machine:

- ``run_greedy`` follows the first selection at every ply and flags the
  lanes that met a multi-selection point (``forked``). A lane that never
  forked has a chain-shaped game tree, so its greedy result is exact.
  Replaces the Pallas ``_greedy_kernel`` (sayuri_tpu/ops/ladder_kernel.py,
  entry ``run_greedy``).
- ``run_chases`` runs the exact depth-first search with a fork stack
  (MAX_FORKS frames, MAX_ALTS alternatives, NODE_CAP descents per lane) on
  the lanes it is given as valid. Replaces the Pallas ``_chase_kernel``
  (entry ``run_chases``).

Reaching NODE_CAP, overflowing the stack or the iteration cap reads as
PREY_GOOD, as in the JAX package. ``node_cap`` and ``max_forks`` are
arguments so that tests can reach those limits on small positions.

A wrapper given CPU tensors computes the plain twin; given CUDA tensors it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sayuri_tpu_torch.ops.analysis import _check, _ptr, _raise_if

ROWS = 32          # padded row count (board size <= 19 < 32)
MAX_FORKS = 56     # fork-stack frames per lane
MAX_ALTS = 4       # stored alternatives per frame (<= 5 selections)
NODE_CAP = 2000    # kMaxLadderNodes (types.h:68), per lane
BIGI = 10**9

# chase results (game/ladder.py values)
UNDECIDED = 0
PREY_GOOD = 1
HUNTER_GOOD = 2

# modes of a lane in the fork-stack search
DESCEND, RETURN = 0, 1

# kernel launches per entry point (CUDA tensors only; the twins never count)
LAUNCHES = {"run_greedy": 0, "run_chases": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_bitboards(mask):
    """[B, n, n] bool -> [B, ROWS] int32 row words (bit x of word y)."""
    n = mask.shape[-1]
    bits = mask.to(torch.int64) << torch.arange(n, device=mask.device)
    words = bits.sum(-1)                                     # [B, n]
    pad = torch.zeros(mask.shape[:-2] + (ROWS - n,), dtype=torch.int64,
                      device=mask.device)
    return torch.cat([words, pad], -1).to(torch.int32)


# ---------------------------------------------------------------------------
# plain twins: lockstep over [L, ROWS] int64 rows (at most 19 bits each)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from sayuri_tpu_torch.ops import build

    return bind(build.load("ladder"))


def bind(lib):
    """Set the argument and result types of ladder.cu's launchers on a
    loaded library; returns it."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_greedy.argtypes = [vp] * 7 + [vp, vp] + [i, i, i, vp]
    lib.launch_greedy.restype = i
    lib.launch_chases.argtypes = [vp] * 7 + [vp] + [i, i, i, i, vp]
    lib.launch_chases.restype = i
    return lib


def _check_lanes(own_words, opp_words, scalars):
    L = own_words.shape[0] if own_words.ndim == 2 else -1
    dev = own_words.device
    _check("own_words", own_words, torch.int32, (L, ROWS), dev)
    _check("opp_words", opp_words, torch.int32, (L, ROWS), dev)
    for k, t in scalars.items():
        _check(k, t, torch.int32, (L,), dev)
    return L


def _device_of(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def run_greedy(own_words, opp_words, size, ko, prey_v, first_hunter_v, valid,
               n, node_cap=NODE_CAP):
    """Greedy pass over L lanes: [L, ROWS] int32 own (prey colour) and opp
    words, [L] int32 size/ko/prey_v/first_hunter_v (-1: the prey moves
    first)/valid. Returns (result [L], forked [L]) int32; `result` is exact
    wherever forked == 0."""
    if _device_of("run_greedy", own_words) == "cpu":
        return run_greedy_plain(own_words, opp_words, size, ko, prey_v,
                                first_hunter_v, valid, n, node_cap)
    args = dict(size=size, ko=ko, prey_v=prey_v, first_hunter_v=first_hunter_v,
                valid=valid)
    L = _check_lanes(own_words, opp_words, args)
    result = torch.empty((L,), dtype=torch.int32, device=own_words.device)
    forked = torch.empty_like(result)
    if L:
        stream = torch.cuda.current_stream(own_words.device).cuda_stream
        rc = _lib().launch_greedy(
            _ptr(own_words), _ptr(opp_words), *(_ptr(t) for t in args.values()),
            _ptr(result), _ptr(forked), L, n, node_cap, ctypes.c_void_p(stream))
        _raise_if(rc, "run_greedy")
        LAUNCHES["run_greedy"] += 1
    return result, forked


def run_chases(own_words, opp_words, size, ko, prey_v, first_hunter_v, valid,
               n, node_cap=NODE_CAP, max_forks=MAX_FORKS):
    """Exact fork-stack chases on the lanes flagged `valid` (same inputs as
    run_greedy). Returns result [L] int32; other lanes read PREY_GOOD."""
    if _device_of("run_chases", own_words) == "cpu":
        return run_chases_plain(own_words, opp_words, size, ko, prey_v,
                                first_hunter_v, valid, n, node_cap, max_forks)
    if not 0 <= max_forks <= MAX_FORKS:
        raise ValueError(f"max_forks {max_forks} outside [0, {MAX_FORKS}]")
    args = dict(size=size, ko=ko, prey_v=prey_v, first_hunter_v=first_hunter_v,
                valid=valid)
    L = _check_lanes(own_words, opp_words, args)
    result = torch.empty((L,), dtype=torch.int32, device=own_words.device)
    if L:
        stream = torch.cuda.current_stream(own_words.device).cuda_stream
        rc = _lib().launch_chases(
            _ptr(own_words), _ptr(opp_words), *(_ptr(t) for t in args.values()),
            _ptr(result), L, n, node_cap, max_forks, ctypes.c_void_p(stream))
        _raise_if(rc, "run_chases")
        LAUNCHES["run_chases"] += 1
    return result
