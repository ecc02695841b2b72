"""Self-play game randomization: board/komi/rule sampling, handicaps,
random openings, fair/unfair komi (PyTorch port of
sayuri_tpu.selfplay.randomize).

- `bkp:<size>:<komi>:<prob>` queries pick each game's board size + komi
- `bhp:<size>:<handicaps>:<prob>` add free-handicap games
- `srs:area[:territory]` sets the scoring-rule pool
- random openings play policy-sampled moves with an exp-decaying
  temperature, floor 0.8
- handicap stones are policy-sampled at temp 0.8 without alternating
- unfair komi jitter ~ N(0, sigma) with a big-sigma tail; all komi
  quantized to the nearest half point (`adjust_komi`)
- fair komi: handicap and opening lanes move their komi by the score lead
  an optional quick search finds (`fair_komi_search`, which the self-play
  pipe passes) before the jitter

The host-side draws (sizes, komi, rules, handicaps, opening lengths,
jitter) come from ``np.random.default_rng(seed)`` in the JAX package's
call order, so the same seed gives the same draws. The policy samples come
from a ``torch.Generator`` seeded with the same integer; they differ from
the JAX package's threefry draws. Each policy step is one evaluator call
and one batched ``GoEnv.step`` (two flood launches on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sayuri_tpu_torch.game.state import GoEnv, GoState
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE


@dataclasses.dataclass(frozen=True)
class GameDistribution:
    board_queries: tuple = ((19, 7.5, 1.0),)   # (size, komi, prob)
    handicap_queries: tuple = ()               # (size, max_handicap, prob)
    scoring_set: tuple = (AREA_RULE,)
    random_opening_prob: float = 0.0
    random_opening_temp: float = 1.2
    random_moves_factor: float = 0.08
    komi_stddev: float = 0.0
    komi_big_stddev: float = 0.0
    komi_big_stddev_prob: float = 0.0
    handicap_fair_komi_prob: float = 0.0

    @property
    def max_boardsize(self) -> int:
        return max(q[0] for q in self.board_queries)


def parse_queries(queries, default_size=19, default_komi=7.5, **kwargs):
    """Parse `selfplay_query` strings into a GameDistribution."""
    board, handicap, scoring = [], [], []
    for q in queries or []:
        parts = q.replace(":", " ").split()
        if not parts:
            continue
        if parts[0] == "bkp" and len(parts) == 4:
            board.append((int(parts[1]), float(parts[2]), float(parts[3])))
        elif parts[0] == "bhp" and len(parts) == 4:
            if int(parts[2]) >= 2:
                handicap.append((int(parts[1]), int(parts[2]), float(parts[3])))
        elif parts[0] == "srs":
            for tok in parts[1:]:
                scoring.append(TERRITORY_RULE if tok == "territory" else AREA_RULE)
    if not board:
        board = [(default_size, default_komi, 1.0)]
    total = sum(p for _, _, p in board)
    board = [(s, k, p / total) for s, k, p in board]
    if not scoring:
        scoring = [AREA_RULE]
    if TERRITORY_RULE in scoring and AREA_RULE not in scoring:
        scoring.append(AREA_RULE)
    scoring = sorted(set(scoring))
    return GameDistribution(
        board_queries=tuple(board),
        handicap_queries=tuple(handicap),
        scoring_set=tuple(scoring),
        **kwargs,
    )


def adjust_komi(komi):
    """Quantize float32 komi to the nearest half point."""
    a = komi.abs()
    ip = torch.floor(a)
    fp = a - ip
    fp = torch.where(fp < 0.25, 0.0, torch.where(fp < 0.75, 0.5, 1.0))
    return torch.sign(komi) * (ip + fp)


def _where_state(flag, new: GoState, old: GoState) -> GoState:
    """Per lane: `new` where `flag` ([B] bool), else `old`."""
    return GoState(**{
        k: torch.where(flag.view(flag.shape + (1,) * (v.ndim - 1)), v, getattr(old, k))
        for k, v in new.fields().items()
    })


class GameRandomizer:
    """Prepares a batch of randomized starting positions."""

    def __init__(self, env: GoEnv, dist: GameDistribution, eval_fn,
                 fair_komi_search=None):
        self.env = env
        self.dist = dist
        self.eval_fn = eval_fn
        # optional callable(states) -> [B] side-to-move score lead
        self.fair_komi_search = fair_komi_search

    @torch.no_grad()
    def _policy_step(self, states: GoState, gen: torch.Generator, temp: float,
                     play_color: int) -> GoState:
        """Sample a non-pass move ~ policy^(1/temp) per lane (Gumbel-max)
        and play it. `play_color` -1 plays for the side to move, else forces
        that colour (handicap stones)."""
        evals = self.eval_fn(states, None)
        logits = torch.log(evals.priors.clamp(min=1e-25)) / temp
        logits[:, -1] = -torch.inf
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        moves = (logits + gumbel).argmax(-1).to(torch.int32)
        if play_color >= 0:
            states = states.replace(to_move=torch.full_like(states.to_move, play_color))
        return self.env.step(states, moves)

    def prepare(self, batch: int, seed: int, device="cuda") -> GoState:
        """`batch` randomized starting positions on `device`; `seed` seeds
        the host draws and the policy samples."""
        dist = self.dist
        rng_np = np.random.default_rng(seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        # per-lane board size / komi / rule (host-side per-game scalars)
        probs = np.asarray([q[2] for q in dist.board_queries])
        picks = rng_np.choice(len(dist.board_queries), size=batch, p=probs)
        sizes = np.asarray([dist.board_queries[i][0] for i in picks])
        komis = np.asarray([dist.board_queries[i][1] for i in picks])
        rules = rng_np.choice(np.asarray(dist.scoring_set), size=batch)

        def lanes(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        states = self.env.new_batch(batch, device=device).replace(
            size=lanes(sizes, torch.int32),
            komi=lanes(komis, torch.float32),
            rule=lanes(rules, torch.int32),
        )

        # handicaps: h - 1 policy-sampled black stones, then black to move
        # (the JAX package's placement)
        handicaps = np.zeros(batch, np.int64)
        for size, max_h, prob in dist.handicap_queries:
            match = sizes == size
            roll = rng_np.random(batch) < prob
            h = rng_np.integers(2, max(max_h, 2) + 1, size=batch)
            handicaps = np.where(match & roll, h, handicaps)
        max_h = int(handicaps.max()) if batch else 0
        if max_h > 0:
            for i in range(max_h - 1):
                stepped = self._policy_step(states, gen, 0.8, 0)
                states = _where_state(lanes(handicaps - 1 > i, torch.bool),
                                      stepped, states)
            states = states.replace(
                handicap=lanes(handicaps, torch.int32),
                to_move=torch.zeros_like(states.to_move),
            )

        # random openings
        do_open = rng_np.random(batch) < dist.random_opening_prob
        cnt = (
            dist.random_moves_factor * sizes.astype(np.float64) ** 2
            + rng_np.normal(0.0, sizes / 4.0)
        ).astype(np.int64)
        open_moves = np.where(do_open, np.maximum(cnt, 0), 0)
        lam = 0.69314718056 / sizes
        max_open = int(open_moves.max()) if batch else 0
        for i in range(max_open):
            # one shared temperature per step (the lanes' mean; per-lane
            # temperatures differ only across board sizes)
            temp = np.maximum(dist.random_opening_temp * np.exp(-lam * i), 0.8)
            stepped = self._policy_step(states, gen, float(np.float32(temp.mean())), -1)
            states = _where_state(lanes(open_moves > i, torch.bool), stepped, states)

        # fair komi for handicap / opening lanes
        need_fair = (handicaps > 0) | (open_moves > 0)
        if need_fair.any() and self.fair_komi_search is not None:
            lead_stm = self.fair_komi_search(states).cpu().numpy()
            to_move = states.to_move.cpu().numpy()
            lead_black = np.where(to_move == 0, lead_stm, -lead_stm)
            new_komi = adjust_komi(lanes(np.where(need_fair, komis + lead_black, komis),
                                         torch.float32))
            states = states.replace(komi=new_komi)
            komis = new_komi.cpu().numpy()

        # unfair komi jitter; handicap games keep fair komi with prob
        # handicap_fair_komi_prob
        stddev = np.where(
            rng_np.random(batch) < dist.komi_big_stddev_prob,
            dist.komi_big_stddev,
            dist.komi_stddev,
        )
        bonus = rng_np.normal(0.0, np.maximum(stddev, 1e-9))
        bonus = np.where(stddev > 0, bonus, 0.0)
        keep_fair = (handicaps > 0) & (
            rng_np.random(batch) < dist.handicap_fair_komi_prob
        )
        new_komi = np.where(keep_fair, komis, komis + bonus)
        return states.replace(komi=adjust_komi(lanes(new_komi, torch.float32)))
