"""Post-search move hygiene for real-game play (a copy of
sayuri_tpu.mcts.hygiene, which is numpy only).

Implements the reference's root-position cleanup that runs after a search
and before the move is returned (GetBestMove, search.cc:830-861):

- dead / alive string classification from the search's averaged root
  ownership, with pass-alive overrides (search.cc:640-683)
- friendly pass: pass immediately when the NN-cleaned position is already
  won (ShouldPass, search.cc:780-829)
- capture-all-dead: when about to pass under area scoring with capturable
  dead stones still on the board, play a capturing / dame-filling move
  first (search.cc:685-732)

These run on the host over a single game (the GTP path); the board is tiny
so plain numpy flood fills are cheaper than a device round-trip. The
batched self-play path has its own vectorized equivalent of the forbid-pass
rule (selfplay/actor.py).
"""

from __future__ import annotations

import numpy as np

OWNERSHIP_THRESHOLD = 0.75  # kOwnershipThreshold, search.cc:641

_NEIGH = ((1, 0), (-1, 0), (0, 1), (0, -1))


def chain_labels_np(stones: np.ndarray) -> np.ndarray:
    """[n, n] int32: per same-color 4-connected chain id, -1 off-stone.

    Host-side replacement for the string set (strings.h) on a single
    board; ids are the min flat index of the chain."""
    n = stones.shape[-1]
    labels = np.full((n, n), -1, np.int32)
    for y in range(n):
        for x in range(n):
            c = stones[y, x]
            if c == 0 or labels[y, x] >= 0:
                continue
            stack = [(y, x)]
            labels[y, x] = y * n + x
            while stack:
                cy, cx = stack.pop()
                for dy, dx in _NEIGH:
                    ny, nx = cy + dy, cx + dx
                    if (
                        0 <= ny < n
                        and 0 <= nx < n
                        and stones[ny, nx] == c
                        and labels[ny, nx] < 0
                    ):
                        labels[ny, nx] = y * n + x
                        stack.append((ny, nx))
    return labels


def chain_liberty_map_np(stones: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """[n, n] int32: liberty count of the chain each stone belongs to."""
    n = stones.shape[-1]
    libs: dict[int, set] = {}
    for y in range(n):
        for x in range(n):
            lbl = labels[y, x]
            if lbl < 0:
                continue
            s = libs.setdefault(int(lbl), set())
            for dy, dx in _NEIGH:
                ny, nx = y + dy, x + dx
                if 0 <= ny < n and 0 <= nx < n and stones[ny, nx] == 0:
                    s.add((ny, nx))
    out = np.zeros((n, n), np.int32)
    for y in range(n):
        for x in range(n):
            lbl = labels[y, x]
            if lbl >= 0:
                out[y, x] = len(libs[int(lbl)])
    return out


def owner_map(
    safe: np.ndarray,
    safe_own: np.ndarray,
    root_own_black: np.ndarray,
    color: int,
) -> np.ndarray:
    """[n, n] float in to-move perspective (+1 = mine).

    Pass-alive cells override the search ownership with a hard ±1 from the
    score-area ownership (search.cc:643-656, 713-715)."""
    my_own = 1 if color == 0 else -1
    sign = 1.0 if color == 0 else -1.0
    return np.where(
        safe,
        np.where(safe_own == my_own, 1.0, -1.0),
        root_own_black * sign,
    )


def dead_alive_masks(
    stones: np.ndarray,
    owner: np.ndarray,
    color: int,
    threshold: float = OWNERSHIP_THRESHOLD,
):
    """(dead, alive) [n, n] bool stone masks (search.cc:640-683).

    A chain is dead when any of its stones sits in territory the search
    gives to the other color with > `threshold` confidence; alive when the
    territory matches the stone's color. Whole chains are marked (the
    reference collects GetStringList per triggering vertex)."""
    my_stone = color + 1
    opp_stone = 2 - color
    labels = chain_labels_np(stones)
    dead_seed = ((owner > threshold) & (stones == opp_stone)) | (
        (owner < -threshold) & (stones == my_stone)
    )
    alive_seed = ((owner > threshold) & (stones == my_stone)) | (
        (owner < -threshold) & (stones == opp_stone)
    )
    on = stones > 0
    dead = on & np.isin(labels, np.unique(labels[dead_seed & on]))
    alive = on & np.isin(labels, np.unique(labels[alive_seed & on]))
    return dead, alive


def should_pass(
    stones: np.ndarray,
    dead: np.ndarray,
    color: int,
    movenum: int,
    last_move_was_pass: bool,
    score_fn,
) -> bool:
    """Friendly pass (ShouldPass, search.cc:780-829).

    After the opponent passes under area scoring (and past n^2/3 moves),
    remove the search-predicted dead strings; if no remaining chain is in
    atari and the cleaned position already wins for the side to move,
    answer with a pass to end the game. `score_fn(cleaned_stones)` must
    return the final score from BLACK's view (GetFinalScore semantics,
    dead stones already removed)."""
    n = stones.shape[-1]
    if not last_move_was_pass:
        return False
    if movenum <= (n * n) // 3:
        return False
    cleaned = np.where(dead, 0, stones)
    labels = chain_labels_np(cleaned)
    libs = chain_liberty_map_np(cleaned, labels)
    if ((cleaned > 0) & (libs == 1)).any():
        # a live string in atari: the game is not settled yet
        return False
    score_black = float(score_fn(cleaned))
    score = score_black if color == 0 else -score_black
    return score > 0.1


def is_capture_move(
    stones: np.ndarray, libs: np.ndarray, y: int, x: int, color: int
) -> bool:
    """Playing at (y, x) captures an adjacent opponent chain in atari
    (Board::IsCaptureMove)."""
    n = stones.shape[-1]
    opp_stone = 2 - color
    for dy, dx in _NEIGH:
        ny, nx = y + dy, x + dx
        if (
            0 <= ny < n
            and 0 <= nx < n
            and stones[ny, nx] == opp_stone
            and libs[ny, nx] == 1
        ):
            return True
    return False


def capture_all_dead_move(
    stones: np.ndarray,
    owner: np.ndarray,
    raw_own: np.ndarray,
    legal: np.ndarray,
    superko_violation: np.ndarray,
    color: int,
    rng: np.random.RandomState,
    threshold: float = OWNERSHIP_THRESHOLD,
):
    """Pick a dead-stone capture / dame fill instead of passing
    (search.cc:685-732). Returns a flat vertex or None.

    Candidates are legal points the search assigns to us with > `threshold`
    confidence that are either (a) raw-neutral dame adjacent to an own
    string or (b) inside a raw-opponent area (a dead group's eye). Capture
    moves come first; ties are shuffled; superko repetitions are skipped.

    `raw_own` is the reach-area ownership (GetRawOwnership,
    game_state.cc:515-521), `legal` the [n*n] legality mask for `color`,
    `superko_violation` the [n*n(+1)] positional-superko mask."""
    n = stones.shape[-1]
    my_stone = color + 1
    opp_raw = -1 if color == 0 else 1
    labels = chain_labels_np(stones)
    libs = chain_liberty_map_np(stones, labels)
    fills = []
    for y in range(n):
        for x in range(n):
            v = y * n + x
            if owner[y, x] <= threshold or not legal[v]:
                continue
            raw = raw_own[y, x]
            near_mine = any(
                0 <= y + dy < n
                and 0 <= x + dx < n
                and stones[y + dy, x + dx] == my_stone
                for dy, dx in _NEIGH
            )
            if (raw == 0 and stones[y, x] == 0 and near_mine) or raw == opp_raw:
                fills.append((y, x))
    if not fills:
        return None
    rng.shuffle(fills)
    fills.sort(key=lambda p: -int(is_capture_move(stones, libs, *p, color)))
    for y, x in fills:
        v = y * n + x
        if not superko_violation[v]:
            return v
    return None
