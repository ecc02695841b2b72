"""Batched Go game state and environment (PyTorch port of
sayuri_tpu.game.state).

``GoState`` is a dataclass of tensors that all carry the batch dimension
first (the JAX package holds one game and ``vmap``s; here the batch is
written out). An 8-deep board-history ring feeds the encoder's history
planes, and positional superko uses a ring of board hashes. Hashes are two
32-bit words held in int64.

States are born on the card: ``GoEnv.new_batch`` defaults to
``device="cuda"``, and a CPU caller passes ``device="cpu"``. On the card the
board fixpoints of ``step``, the legality, superko and ownership queries run
as the flood and labels kernels (game/board.py -> ops/flood.py), the light
and analysed steps as one step kernel each (ops/analysis.py).
"""

from __future__ import annotations

import dataclasses

import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.types import AREA_RULE, BLACK, NO_VERTEX

HISTORY_LEN = 8  # encoder history depth


@dataclasses.dataclass
class GoState:
    """Batch of games. All tensors have the batch dimension first."""

    stones: torch.Tensor        # [B, n, n] int8: 0 empty, 1 black, 2 white
    to_move: torch.Tensor       # [B] int32: 0 black / 1 white
    ko: torch.Tensor            # [B] int32 flat vertex or -1
    pass_count: torch.Tensor    # [B] int32 consecutive passes
    move_count: torch.Tensor    # [B] int32
    last_moves: torch.Tensor    # [B, HISTORY_LEN] int32 (-1 pass/none)
    history: torch.Tensor       # [B, HISTORY_LEN, n, n] int8 boards after moves t-1..t-H
    hash: torch.Tensor          # [B, 2] int64 board-only hash (32-bit words)
    hash_history: torch.Tensor  # [B, max_len, 2] int64 hashes of past positions
    size: torch.Tensor          # [B] int32 board size <= n
    komi: torch.Tensor          # [B] float32
    rule: torch.Tensor          # [B] int32 AREA_RULE / TERRITORY_RULE
    handicap: torch.Tensor      # [B] int32
    prisoners: torch.Tensor     # [B, 2] int32 captures by (black, white)
    played_stones: torch.Tensor  # [B, 2] int32 non-pass moves by (black, white)
    terminated: torch.Tensor    # [B] bool

    @property
    def n(self) -> int:
        return self.stones.shape[-1]

    def replace(self, **kw) -> "GoState":
        return dataclasses.replace(self, **kw)

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def map(self, fn) -> "GoState":
        """Apply `fn` to every tensor field."""
        return GoState(**{k: fn(v) for k, v in self.fields().items()})

    def to(self, device) -> "GoState":
        return self.map(lambda x: x.to(device))


def _bcast(flag, like):
    return flag.view(flag.shape + (1,) * (like.ndim - flag.ndim))


class GoEnv:
    """Batched Go environment over a fixed n x n buffer; ``size`` (per
    game) is at most ``n``."""

    def __init__(self, n: int = 19, max_len: int | None = None):
        self.n = n
        self.max_len = max_len if max_len is not None else 2 * n * n + 32
        self.pass_action = n * n
        self.num_actions = n * n + 1

    # -- construction ------------------------------------------------------

    def new_batch(self, batch: int, size=None, komi=7.5, rule=AREA_RULE,
                  device="cuda", handicap=0) -> GoState:
        """`batch` empty boards; `handicap` stones counted for the area
        rule's komi penalty (``new_batch(1, ...)`` stands for the JAX
        package's single-game ``new_state``)."""
        n = self.n
        size = n if size is None else size
        i32 = torch.int32

        def full(shape, val, dtype):
            return torch.full(shape, val, dtype=dtype, device=device)

        empty = torch.zeros((batch, n, n), dtype=torch.int8, device=device)
        return GoState(
            stones=empty,
            to_move=full((batch,), BLACK, i32),
            ko=full((batch,), NO_VERTEX, i32),
            pass_count=full((batch,), 0, i32),
            move_count=full((batch,), 0, i32),
            last_moves=full((batch, HISTORY_LEN), NO_VERTEX, i32),
            history=torch.zeros((batch, HISTORY_LEN, n, n), dtype=torch.int8,
                                device=device),
            hash=B.position_hash(empty),
            hash_history=full((batch, self.max_len, 2), 0, torch.int64),
            size=full((batch,), size, i32),
            komi=full((batch,), komi, torch.float32),
            rule=full((batch,), rule, i32),
            handicap=full((batch,), handicap, i32),
            prisoners=full((batch, 2), 0, i32),
            played_stones=full((batch, 2), 0, i32),
            terminated=full((batch,), False, torch.bool),
        )

    # -- core transitions --------------------------------------------------

    def step(self, states: GoState, actions) -> GoState:
        """Apply one action per game (flat vertex or pass) with the board
        functions (two flood launches on the card). Assumes legal actions;
        terminated games freeze."""
        nn = self.n * self.n
        actions = torch.as_tensor(actions, device=states.stones.device).to(torch.int32)
        is_pass = actions >= self.pass_action
        stones_p, n_cap, ko_p = B.play_move(
            states.stones, states.size, states.to_move, actions.clamp(max=nn - 1)
        )
        new_stones = torch.where(_bcast(is_pass, stones_p), states.stones, stones_p)
        out = {
            "new_stones": new_stones,
            "n_captured": torch.where(is_pass, 0, n_cap).to(torch.int32),
            "new_ko": torch.where(is_pass, NO_VERTEX, ko_p).to(torch.int32),
            "new_hash": B.position_hash(new_stones),
        }
        return self._merge_kernel_step(states, actions, out)

    def step_batch_with_analysis(self, states: GoState, actions):
        """Batched step + child-position analysis: ONE step+analysis kernel
        launch on CUDA, its plain twin on the CPU (ops/analysis.py).
        Returns (new_states, analysis dict)."""
        from sayuri_tpu_torch.ops.analysis import step_and_analyze

        actions = actions.to(torch.int32)
        out = step_and_analyze(
            states.stones, states.size, states.ko, states.to_move, actions
        )
        return self._merge_kernel_step(states, actions, out), out

    def step_batch_light(self, states: GoState, actions):
        """Batched step + the child's legality only (the raw env-stepping
        path): ONE light step kernel launch on CUDA, its plain twin on the
        CPU. Returns (new_states, legal [B, n*n] bool). As the JAX package's
        kernel branch, `legal` is the child's board legality even on
        terminated lanes (its CPU branch masks those to False)."""
        from sayuri_tpu_torch.ops.analysis import step_and_legal

        actions = actions.to(torch.int32)
        out = step_and_legal(
            states.stones, states.size, states.ko, states.to_move, actions
        )
        return self._merge_kernel_step(states, actions, out), out["legal"]

    def _merge_kernel_step(self, states: GoState, actions, out) -> GoState:
        """Fold a step output dict into the full GoState update (history
        ring, superko ring, prisoner/pass bookkeeping, freeze of terminated
        games)."""
        is_pass = actions >= self.pass_action
        color = states.to_move.to(torch.int64)
        b_idx = torch.arange(color.shape[0], device=color.device)
        new_stones = out["new_stones"].to(torch.int8)

        move_v = torch.where(is_pass, NO_VERTEX, actions).to(torch.int32)
        new_last = torch.cat([move_v[:, None], states.last_moves[:, :-1]], 1)
        new_history = torch.cat([new_stones[:, None], states.history[:, :-1]], 1)
        new_prisoners = states.prisoners.clone()
        new_prisoners[b_idx, color] += torch.where(
            is_pass, 0, out["n_captured"]
        ).to(torch.int32)
        new_played = states.played_stones.clone()
        new_played[b_idx, color] += (~is_pass).to(torch.int32)
        # record the position being LEFT into the superko ring; a shorter
        # ring (the search tree's length-1 stub) drops slots past its end,
        # as the JAX package's out-of-bounds scatter does
        hh = states.hash_history.clone()
        slot = (states.move_count % self.max_len).to(torch.int64)
        keep = slot < hh.shape[1]
        hh[b_idx, slot.clamp(max=hh.shape[1] - 1)] = torch.where(
            keep[:, None], states.hash, hh[b_idx, slot.clamp(max=hh.shape[1] - 1)]
        )
        new_pass = torch.where(is_pass, states.pass_count + 1, 0).to(torch.int32)
        terminated = states.terminated | (new_pass >= 2)

        stepped = states.replace(
            stones=new_stones,
            to_move=(1 - states.to_move).to(torch.int32),
            ko=out["new_ko"].to(torch.int32),
            pass_count=new_pass,
            move_count=states.move_count + 1,
            last_moves=new_last,
            history=new_history,
            hash=out["new_hash"],
            hash_history=hh,
            prisoners=new_prisoners,
            played_stones=new_played,
            terminated=terminated,
        )
        frozen = states.terminated
        old = states.fields()
        return GoState(**{
            k: torch.where(_bcast(frozen, v), old[k], v)
            for k, v in stepped.fields().items()
        })

    # -- queries -----------------------------------------------------------

    def legal_action_mask(self, states: GoState) -> torch.Tensor:
        """[B, n*n + 1] bool; pass always legal. No superko filtering."""
        board_legal = B.legal_moves(
            states.stones, states.size, states.to_move, states.ko
        ) & ~states.terminated[:, None]
        ones = torch.ones_like(board_legal[:, :1])
        return torch.cat([board_legal, ones], 1)

    def _superko_hits(self, states: GoState, actions) -> torch.Tensor:
        """[B, K] bool for [B, K] actions: would the action recreate a
        position of the hash ring (or the current one)? All B*K moves go
        through one batched play_move. Pass never violates."""
        nn = self.n * self.n
        k = actions.shape[1]
        stones_p, _, _ = B.play_move(
            states.stones[:, None].expand(-1, k, -1, -1), states.size[:, None],
            states.to_move[:, None], actions.clamp(max=nn - 1),
        )
        h = B.position_hash(stones_p)                      # [B, K, 2]
        hh = states.hash_history                          # [B, L, 2]
        valid = (torch.arange(hh.shape[1], device=hh.device)
                 < states.move_count.clamp(max=self.max_len)[:, None])
        same = ((h[:, :, None, 0] == hh[:, None, :, 0])
                & (h[:, :, None, 1] == hh[:, None, :, 1]))  # [B, K, L]
        hit = (same & valid[:, None]).any(-1) | (h == states.hash[:, None]).all(-1)
        return hit & (actions < self.pass_action)

    def superko_violation(self, states: GoState, actions) -> torch.Tensor:
        """[B] bool: would `actions` ([B]) recreate a previous position
        (positional superko over the hash ring)? Pass never violates."""
        actions = torch.as_tensor(actions, device=states.stones.device)
        return self._superko_hits(states, actions.to(torch.int64)[:, None])[:, 0]

    def superko_action_mask(self, states: GoState) -> torch.Tensor:
        """[B, n*n + 1] bool: True where the action would violate positional
        superko. Every board action of every lane is played in one batched
        play_move ([B, n*n] boards: two flood launches on the card); pass
        is never a violation."""
        b = states.stones.shape[0]
        acts = torch.arange(self.pass_action, device=states.stones.device)
        hits = self._superko_hits(states, acts.expand(b, -1))
        return torch.cat([hits, torch.zeros_like(hits[:, :1])], 1)

    def final_score(self, states: GoState) -> torch.Tensor:
        """[B] float32 black-minus-white score under area scoring of the
        board (pass-alive / pass-dead areas over the reach ownership),
        minus komi with penalty. The score-area ownership is the analysis
        kernel's on the card, its plain twin on the CPU. Territory-rule
        games get no dead-stone removal here (see final_score_with_helper)."""
        from sayuri_tpu_torch.ops.analysis import board_analysis

        sown = board_analysis(states.stones, states.size, states.ko,
                              states.to_move)["score_ownership"]
        board_score = sown.flatten(1).sum(-1).to(torch.float32)
        return board_score - self.komi_with_penalty(states)

    def _helper_cleaned(self, states: GoState, helper_own):
        """Stones with the territory helper's dead strings removed on
        territory-rule lanes; area-rule lanes keep their board."""
        from sayuri_tpu_torch.game import analysis as GA

        cleaned = GA.remove_dead_stones(states.stones, states.size, helper_own)
        area = (states.rule == AREA_RULE)[:, None, None]
        return torch.where(area, states.stones, cleaned)

    def final_score_with_helper(self, states: GoState, helper_own) -> torch.Tensor:
        """[B] float32 black-minus-white final score honouring the
        territory helper (`helper_own` [B, n, n] in {-1, 0, +1} from the
        area-rule playout): on territory-rule lanes the strings it
        contradicts are removed before area scoring. The score area of the
        cleaned board is the analysis kernel's on the card."""
        from sayuri_tpu_torch.game import analysis as GA

        sown = GA.score_ownership(self._helper_cleaned(states, helper_own),
                                  states.size)
        board_score = sown.flatten(1).sum(-1).to(torch.float32)
        return board_score - self.komi_with_penalty(states)

    def ownership_with_helper(self, states: GoState, helper_own) -> torch.Tensor:
        """[B, n, n] int32 score-area ownership honouring the territory
        helper (as final_score_with_helper)."""
        from sayuri_tpu_torch.game import analysis as GA

        return GA.score_ownership(self._helper_cleaned(states, helper_own),
                                  states.size)

    def ownership(self, states: GoState) -> torch.Tensor:
        """[B, n, n] int64 Tromp-Taylor area ownership (+1 black)."""
        return B.area_ownership(states.stones, states.size)

    def penalty_offset_to_area(self, states: GoState) -> torch.Tensor:
        """[B] float32 komi adjustment that keeps the score when a game
        switches to area scoring; zero for area-rule games."""
        territory_pen = (
            states.played_stones[:, 0] - states.played_stones[:, 1]
        ).to(torch.float32)
        area_pen = states.handicap.to(torch.float32)
        return torch.where(states.rule == AREA_RULE, 0.0, territory_pen - area_pen)

    def komi_penalty(self, states: GoState) -> torch.Tensor:
        """Territory rule adds (black played - white played); area rule
        adds the handicap."""
        territory_pen = (
            states.played_stones[:, 0] - states.played_stones[:, 1]
        ).to(torch.float32)
        area_pen = states.handicap.to(torch.float32)
        return torch.where(states.rule == AREA_RULE, area_pen, territory_pen)

    def komi_with_penalty(self, states: GoState) -> torch.Tensor:
        return states.komi + self.komi_penalty(states)

    def wave(self, states: GoState) -> torch.Tensor:
        """Drawable-komi triangle-wave dither: 0 under territory rule; else
        distance of to-move komi from the nearest drawable komi, folded
        into a [-0.5, 0.5] triangle wave."""
        k = self.komi_with_penalty(states)
        k = torch.where(states.to_move == 1, -k, k)
        even_area = (states.size * states.size) % 2 == 0
        floor_even = torch.floor(k / 2.0) * 2.0
        floor_odd = torch.floor((k - 1.0) / 2.0) * 2.0 + 1.0
        delta = torch.clamp(k - torch.where(even_area, floor_even, floor_odd),
                            0.0, 2.0)
        wave = torch.where(
            delta < 0.5, delta, torch.where(delta < 1.5, 1.0 - delta, delta - 2.0)
        )
        return torch.where(states.rule == AREA_RULE, wave, torch.zeros_like(wave))
