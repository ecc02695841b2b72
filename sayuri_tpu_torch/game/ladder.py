"""Exact ladder planes (PyTorch port of sayuri_tpu.game.ladder).

The front end of the reference's ladder reader (GetLadderMap,
board.cc:1618-1691):

1. candidate chains: every chain with 1 or 2 liberties (board.cc:795-813),
   at most ``max_chains(n)`` per board in ascending root order, from the
   ladder prep maps (ops/analysis.py ``ladder_prep``);
2. two chase lanes per candidate: lane 0 is the atari chase (1 liberty,
   the prey moves first) or the hunter's move on the first liberty, lane 1
   the hunter's move on the second liberty (2 liberties only);
3. the greedy pass over every lane, then the exact fork-stack search on
   the lanes that forked (ops/ladder_kernel.py);
4. the four planes [death, escapable, atari, take] (encoder.cc:248-265):
   1-liberty ladder chains die and their liberty is "take"; 2-liberty
   chains the hunter can ladder are "escapable" and the winning ataris
   are "atari". Where two chains mark one cell, the chain with the higher
   root wins, as GetLadderMap's raster overwrite does.

CPU tensors go through the plain prep and search twins. CUDA tensors go
through the three kernels with no host sync: the grids cover every lane
and idle lanes exit at once.
"""

from __future__ import annotations

import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.types import C_BLACK, C_WHITE, NO_VERTEX
from sayuri_tpu_torch.ops import ladder_kernel as LK
from sayuri_tpu_torch.ops import analysis as TA

# ladder classification results (shared with ops/ladder_kernel.py)
UNDECIDED = LK.UNDECIDED
PREY_GOOD = LK.PREY_GOOD
HUNTER_GOOD = LK.HUNTER_GOOD


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


def _prep_candidates(stones, size, ko, M=None):
    """Plain candidate prep of a batch (sayuri_tpu.game.ladder
    _prep_candidates, batched): the prep maps' labels plus the candidate
    dict of _extract_candidates."""
    if M is None:
        M = max_chains(stones.shape[-1])
    prep = TA.ladder_prep_plain(stones, size, ko)
    return dict(_extract_candidates(prep, stones, M), labels=prep["labels"])


def chase_lanes(stones, size, ko):
    """Steps 1-2 on a batch: (prep maps, candidate dict, lane inputs, ok).
    The lane inputs are [L, ROWS] int32 own (prey colour) and opp words and
    [L] int32 size, ko, prey vertex and first hunter move, L = B *
    max_chains(n) * 2 (both lanes of a candidate alike); ok [L] bool marks
    the lanes to search."""
    b, n = stones.shape[0], stones.shape[-1]
    M = max_chains(n)
    prep = TA.ladder_prep(stones, size, ko)
    c = _extract_candidates(prep, stones, M)
    cand_v, nlibs, l1, l2 = c["cand_v"], c["nlibs"], c["l1"], c["l2"]
    valid = cand_v >= 0

    mask = B.board_mask(size, n)
    bwords = LK.pack_bitboards((stones == C_BLACK) & mask)[:, None]   # [B, 1, 32]
    wwords = LK.pack_bitboards((stones == C_WHITE) & mask)[:, None]
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
    res_g, forked = LK.run_greedy(*args, ok.to(i32), n)
    fv = (forked > 0) & ok
    res_d = LK.run_chases(*args, fv.to(i32), n)
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


def ladder_planes(stones, size, ko=NO_VERTEX):
    """[n, n, 4] float32 ladder planes of one [n, n] board."""
    dev = stones.device
    return ladder_planes_batch(
        stones[None],
        torch.tensor([int(size)], dtype=torch.int32, device=dev),
        torch.tensor([int(ko)], dtype=torch.int32, device=dev),
    )[0]
