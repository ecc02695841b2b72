"""The reference's game state: boards replayed from move lists with the
frozen plain rules, and the 43 input planes worked out from them.

`RefState` holds what the encoder reads for a batch of positions: the
board, the 8 boards before it and the moves that led to them, ko, side to
move, move count, passes, rule, komi and stones played (the territory
rule's komi penalty). `play` advances it by one action (a flat vertex, or
n*n for a pass) and reports whether the move was legal (empty, not the ko
vertex, no suicide). `encode` gives the planes as the reference engine
defines them (encoder v2).
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.reference import frozen as R

HISTORY = 8
AREA, TERRITORY = R.AREA_RULE, R.TERRITORY_RULE


@dataclasses.dataclass
class RefState:
    stones: torch.Tensor      # [B, n, n] int8
    history: torch.Tensor     # [B, 8, n, n] int8, history[:, 0] = stones
    last_moves: torch.Tensor  # [B, 8] int64, -1 for pass or none
    ko: torch.Tensor          # [B] int64, -1 for none
    to_move: torch.Tensor     # [B] int64, 0 black
    move_count: torch.Tensor  # [B] int64
    passes: torch.Tensor      # [B] int64 consecutive passes
    played: torch.Tensor      # [B, 2] int64 board moves by black, white
    rule: torch.Tensor        # [B] int64
    komi: torch.Tensor        # [B] float32

    @property
    def n(self):
        return self.stones.shape[-1]

    def take(self, idx):
        return RefState(**{f.name: getattr(self, f.name)[idx]
                           for f in dataclasses.fields(self)})

    def hash(self):
        return R.position_hash(self.stones)


def empty(batch, n, rule, komi, device):
    z = torch.zeros((batch,), dtype=torch.int64, device=device)
    return RefState(
        stones=torch.zeros((batch, n, n), dtype=torch.int8, device=device),
        history=torch.zeros((batch, HISTORY, n, n), dtype=torch.int8, device=device),
        last_moves=torch.full((batch, HISTORY), -1, dtype=torch.int64, device=device),
        ko=z - 1, to_move=z.clone(), move_count=z.clone(), passes=z.clone(),
        played=torch.zeros((batch, 2), dtype=torch.int64, device=device),
        rule=torch.as_tensor(rule, device=device).to(torch.int64).expand(batch).clone(),
        komi=torch.as_tensor(komi, device=device).to(torch.float32).expand(batch).clone())


def size_of(s: RefState):
    return torch.full((s.stones.shape[0],), s.n, dtype=torch.int32, device=s.stones.device)


def legal_board(s: RefState):
    """[B, n*n] bool: empty, not ko, no suicide (the reference engine's
    IsLegalMove; superko is checked apart)."""
    return R.legal_moves(s.stones, size_of(s), s.to_move, s.ko)


def play(s: RefState, action, keep=None):
    """(next state, legal [B] bool). `action` [B] int64 (n*n = pass);
    rows where `keep` is False are left as they are."""
    n = s.n
    nn = n * n
    action = action.to(torch.int64)
    is_pass = action >= nn
    v = action.clamp(max=nn - 1)
    legal = is_pass | legal_board(s).gather(1, v[:, None])[:, 0]
    stones, _, ko = R.play_move(s.stones, size_of(s), s.to_move, v)
    stones = torch.where(is_pass[:, None, None], s.stones, stones)
    ko = torch.where(is_pass, -1, ko)
    played = s.played.clone()
    played[torch.arange(s.stones.shape[0], device=v.device), s.to_move] += (~is_pass).long()
    nxt = RefState(
        stones=stones,
        history=torch.cat([stones[:, None], s.history[:, :-1]], 1),
        last_moves=torch.cat([torch.where(is_pass, -1, action)[:, None], s.last_moves[:, :-1]], 1),
        ko=ko, to_move=1 - s.to_move, move_count=s.move_count + 1,
        passes=torch.where(is_pass, s.passes + 1, 0), played=played,
        rule=s.rule, komi=s.komi)
    if keep is not None:
        nxt = RefState(**{f.name: torch.where(
            keep.view((-1,) + (1,) * (getattr(nxt, f.name).ndim - 1)),
            getattr(nxt, f.name), getattr(s, f.name)) for f in dataclasses.fields(s)})
    return nxt, legal


def komi_with_penalty(s: RefState):
    pen = (s.played[:, 0] - s.played[:, 1]).to(torch.float32)
    return s.komi + torch.where(s.rule == AREA, 0.0, pen)


def wave(s: RefState):
    """The drawable-komi dither of the reference engine (0 under territory)."""
    k = komi_with_penalty(s)
    k = torch.where(s.to_move == 1, -k, k)
    even = (s.n * s.n) % 2 == 0
    fl = torch.floor(k / 2.0) * 2.0 if even else torch.floor((k - 1.0) / 2.0) * 2.0 + 1.0
    d = torch.clamp(k - fl, 0.0, 2.0)
    w = torch.where(d < 0.5, d, torch.where(d < 1.5, 1.0 - d, d - 2.0))
    return torch.where(s.rule == AREA, w, torch.zeros_like(w))


def analysis(s: RefState):
    """Liberties, safe area, score-area ownership and legality of the side
    to move (frozen plain analysis)."""
    return R.board_analysis_plain(s.stones, size_of(s), s.ko.to(torch.int32),
                                  s.to_move.to(torch.int32))


def encode(s: RefState, ladders, an):
    """[B, n, n, 43] float32 planes (encoder v2): 8 x (own, opponent, last
    move), ko, 4 area planes, 4 liberty planes, 4 ladder planes, rule,
    wave, komi, -komi, intersections, ones. `ladders` [B, n, n, 4]; `an`
    the `analysis` dict."""
    n = s.n
    f32 = torch.float32
    dev = s.stones.device
    tm = s.to_move[:, None, None]
    flat = torch.arange(n * n, device=dev).view(n, n)
    planes = []
    past = torch.clamp(s.move_count + 1, max=HISTORY)
    for p in range(HISTORY):
        board = s.history[:, p]
        valid = (p < past).to(f32)[:, None, None]
        planes += [(board == tm + 1).to(f32) * valid, (board == 2 - tm).to(f32) * valid,
                   (flat == s.last_moves[:, p, None, None]).to(f32) * valid]
    planes.append((flat == s.ko[:, None, None]).to(f32))
    area = (s.rule == AREA).to(f32)[:, None, None]
    mine = torch.where(tm == 0, 1, -1)
    own, safe = an["score_ownership"], an["safe"]
    planes += [(safe & (own == mine)).to(f32) * area, (safe & (own == -mine)).to(f32) * area,
               (own == mine).to(f32) * area, (own == -mine).to(f32) * area]
    stone = s.stones != 0
    for k in (1, 2, 3, 4):
        planes.append((stone & (an["libs"] == k)).to(f32))
    for k in range(4):
        planes.append(ladders[..., k].to(f32))
    ones = torch.ones((s.stones.shape[0], n, n), dtype=f32, device=dev)
    komi = komi_with_penalty(s)
    komi = torch.where(s.to_move == 1, -komi, komi)[:, None, None]
    planes += [ones * (s.rule != AREA).to(f32)[:, None, None], ones * wave(s)[:, None, None],
               ones * komi / 20.0, ones * -komi / 20.0, ones * (n * n) / 361.0, ones]
    return torch.stack(planes, -1)
