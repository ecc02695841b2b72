"""Device-resident shared NN evaluation cache (PyTorch port of
sayuri_tpu.mcts.nncache).

1. A shared 2-way set-associative cache in device memory (keys + NetEvals
   fields as dense [sets, ways, ...] tensors) probed with gathers. All
   lanes share it, so openings and transpositions hit across games.
   Insertion takes the way holding the same key, else a free way, else the
   oldest insertion generation.
2. Cross-lane dedup: lanes querying the same position in one batch are
   served from one representative row.
3. Merge: hits take the cached outputs, duplicates their representative's.

The key covers what the encoder reads except the history planes and the
root ladder planes: the position + side-to-move hash, ko, komi, scoring
rule and board size (two positions that transpose into one share an
entry, as in the reference engine).

The JAX package compacts the unique misses into the smallest power-of-two
row bucket and runs the net on that bucket alone. Choosing a bucket is a
host decision, so the port runs the net on all B rows (no host sync per
simulation), so the cache saves no forward pass here; hits still take the
cached outputs and duplicates their representative's, as in the reference
engine. Lanes that are not live keep the net's output where the JAX
package may leave zeros; nothing reads them (a terminal leaf's prior row
is never expanded).

Entries stay valid across games, moves and tree reuse, but not across
weight reloads: a new MCTS (the pipe builds one on new weights) starts a
new cache.

Counters: `queries` = evaluations requested by live lanes, `hits` = cache
hits among them, `dups` = in-batch duplicates served from a representative
row (per lane, [B] int64); queries - hits - dups are the evaluations that
missed the cache.
"""

from __future__ import annotations

import dataclasses

import torch

from sayuri_tpu_torch import telemetry as T
from sayuri_tpu_torch.game import board as B

_M32 = 0xFFFFFFFF
WAYS = 2


@dataclasses.dataclass
class NNCache:
    keys: torch.Tensor       # [S, W, 2] int64 (two 32-bit words)
    valid: torch.Tensor      # [S, W] bool
    age: torch.Tensor        # [S, W] int64 insertion generation
    tick: torch.Tensor       # [] int64 generation counter
    priors: torch.Tensor     # [S, W, A] f32
    wl: torch.Tensor         # [S, W] f32 (black)
    draw: torch.Tensor       # [S, W] f32
    score: torch.Tensor      # [S, W] f32 (black)
    ownership: torch.Tensor  # [S, W, HW] f32 (black)
    queries: torch.Tensor    # [B] int64 requested evals (live lanes)
    hits: torch.Tensor       # [B] int64 cache hits among them
    dups: torch.Tensor       # [B] int64 in-batch duplicates

    @property
    def num_sets(self) -> int:
        return self.keys.shape[0]

    @property
    def num_ways(self) -> int:
        return self.keys.shape[1]


def make_cache(batch: int, capacity: int, num_actions: int, hw: int,
               device="cuda") -> NNCache:
    """`capacity` sets of WAYS entries; `batch` sizes the per-lane
    counters."""
    ways = WAYS

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i64 = torch.int64
    return NNCache(
        keys=z((capacity, ways, 2), i64), valid=z((capacity, ways), torch.bool),
        age=z((capacity, ways), i64), tick=z((), i64),
        priors=z((capacity, ways, num_actions)), wl=z((capacity, ways)),
        draw=z((capacity, ways)), score=z((capacity, ways)),
        ownership=z((capacity, ways, hw)),
        queries=z((batch,), i64), hits=z((batch,), i64), dups=z((batch,), i64),
    )


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x < 2**32 and a 32-bit constant c, in
    two 16-bit halves of c so that no product leaves int64."""
    lo = (x * (c & 0xFFFF)) & _M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def state_keys(states) -> torch.Tensor:
    """[B, 2] int64 cache keys (32-bit words, the JAX package's uint32
    keys): the position hash with the side-to-move key folded in, then ko,
    komi (x2, truncated), rule and board size mixed into both words with
    different rotations."""
    stm = B._zobrist_stm(states.n, str(states.stones.device))   # [2 words, 2]
    h = states.hash ^ stm[:, states.to_move.to(torch.int64)].T   # [B, 2]
    u32 = lambda x: x.to(torch.int64) & _M32                     # noqa: E731
    mix = (
        _mul32(u32(states.ko + 2), 2654435761)
        ^ _mul32(u32((states.komi * 2.0).to(torch.int32)), 40503)
        ^ _mul32(u32(states.rule), 2246822519)
        ^ _mul32(u32(states.size), 3266489917)
    )
    k0 = h[:, 0] ^ mix
    k1 = h[:, 1] ^ (((mix << 13) & _M32) | (mix >> 19))
    return torch.stack([k0, k1], -1)


def _slot(keys, num_sets: int):
    return keys[:, 0] % num_sets


def probe(cache: NNCache, keys):
    """-> (hit [B] bool, (priors, wl, draw, score, ownership) gathered from
    the cache, (set index, way match [B, W]))."""
    idx = _slot(keys, cache.num_sets)
    match = cache.valid[idx] & (cache.keys[idx] == keys[:, None, :]).all(-1)
    hit = match.any(-1)
    way = match.to(torch.int8).argmax(-1)
    return hit, (
        cache.priors[idx, way], cache.wl[idx, way], cache.draw[idx, way],
        cache.score[idx, way], cache.ownership[idx, way],
    ), (idx, match)


def insert(cache: NNCache, keys, evals, mask, probe_aux=None) -> NNCache:
    """Write `evals` (NetEvals) for the lanes where `mask`. Victim way: the
    way holding the same key, else the first free way, else the oldest.
    Lanes that pick the same (set, way) in one batch resolve to the last
    such lane, on every field alike (what the JAX package's scatter does on
    the CPU), so no entry mixes two lanes' outputs."""
    b = keys.shape[0]
    dev = keys.device
    if probe_aux is not None:
        idx, match = probe_aux
    else:
        idx = _slot(keys, cache.num_sets)
        match = cache.valid[idx] & (cache.keys[idx] == keys[:, None, :]).all(-1)
    vld = cache.valid[idx]
    has_match = match.any(-1)
    match_way = match.to(torch.int8).argmax(-1)
    free_way = (~vld).to(torch.int8).argmax(-1)
    old_way = cache.age[idx].argmin(-1)
    way = torch.where(has_match, match_way,
                      torch.where(vld.all(-1), old_way, free_way))

    # the last masked lane writing each (set, way) wins
    lane = torch.arange(b, device=dev)
    slot = idx * cache.num_ways + way
    winner = torch.full((cache.num_sets * cache.num_ways,), -1, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(0, slot, torch.where(mask, lane, -1), "amax")
    write = mask & (winner[slot] == lane)
    s_idx = torch.where(write, idx, cache.num_sets)      # masked: dropped below

    def upd(buf, vals):
        pad = torch.zeros((1,) + buf.shape[1:], dtype=buf.dtype, device=dev)
        out = torch.cat([buf, pad])
        out[s_idx, way] = vals.to(buf.dtype)
        return out[:-1]

    tick = cache.tick + 1
    return dataclasses.replace(
        cache,
        keys=upd(cache.keys, keys),
        valid=upd(cache.valid, torch.ones((b,), dtype=torch.bool, device=dev)),
        age=upd(cache.age, tick.expand(b)),
        tick=tick,
        priors=upd(cache.priors, evals.priors),
        wl=upd(cache.wl, evals.black_wl),
        draw=upd(cache.draw, evals.draw),
        score=upd(cache.score, evals.black_score),
        ownership=upd(cache.ownership, evals.black_ownership),
    )


def cached_eval(cache: NNCache, eval_fn, states, ctx, live=None):
    """Evaluate `states` through the cache -> (NetEvals, NNCache).

    `live` ([B] bool): lanes whose output is consumed (active and not
    terminal); the others are left out of the counters and of the insert.
    The cache's own work is the recorder's `evaluate.cache` span (host
    time only, as the evaluator's sub-stages).
    """
    from sayuri_tpu_torch.mcts.core import NetEvals

    b = states.stones.shape[0]
    dev = states.stones.device
    with T.span("evaluate.cache", profiled=False):
        if live is None:
            live = torch.ones((b,), dtype=torch.bool, device=dev)

        keys = state_keys(states)
        hit, cached, probe_aux = probe(cache, keys)
        hit = hit & live
        miss = live & ~hit

        # cross-lane dedup: the first missing lane of each key represents it
        eq = (keys[:, None, :] == keys[None, :, :]).all(-1)        # [B, B]
        rep = (eq & miss[None, :]).to(torch.int8).argmax(1)
        lane = torch.arange(b, device=dev)
        need = miss & (rep == lane)
        dup = miss & (rep != lane)

    evals = eval_fn(states, ctx)
    with T.span("evaluate.cache", profiled=False):
        evals = NetEvals(*(x.float() for x in evals))
        # duplicates copy their representative's fresh output, hits the cache's
        merged = NetEvals(*(
            torch.where(hit.view((b,) + (1,) * (x.ndim - 1)), c,
                        torch.where(dup.view((b,) + (1,) * (x.ndim - 1)), x[rep], x))
            for x, c in zip(evals, cached)
        ))
        cache = insert(cache, keys, merged, need, probe_aux)
        cache = dataclasses.replace(
            cache,
            queries=cache.queries + live.to(torch.int64),
            hits=cache.hits + hit.to(torch.int64),
            dups=cache.dups + dup.to(torch.int64),
        )
    return merged, cache
