"""Vectorized self-play actor (PyTorch port of sayuri_tpu.selfplay.actor).

B games advance in lockstep: each move runs, for every game at once, the
root superko purge, the root ladder planes, a batched search (Gumbel or
PUCT, playout-cap randomization, tree reuse, the NN cache), move selection
with forbid-pass and random moves, the training record, and one env step;
the host loop iterates moves until every game has ended (one host sync a
move).

- playout-cap randomization: each lane independently runs a fast
  (no-exploring, reduced-playout) or a full search; fast-search positions
  are marked discard
- forbid-pass for data quality (`_forbid_pass`)
- resign bookkeeping: lanes whose evaluation collapsed keep playing, but
  further positions are mostly fast-searched and discarded
- random opening / fast-search moves proportional to visits
- targets (`assemble_targets`): completed-Q target policy with damping and
  pruning, windowed average Q / score, short/middle/long-term values with
  the KataGo lambdas, ownership, the next move's policy as aux policy
- territory-rule lanes get the helper playout (`territory_playout`)

Plain eager functions: the score ownership comes from the analysis kernel
(``board_analysis``), the neutral-region labels from the labels kernel,
the steps from the step+analysis kernel, the superko purge from the flood
kernel and the ladder planes from the ladder kernels, on the card. Random
draws come from one ``torch.Generator`` per game batch, drawn in the JAX
package's call order (the numbers differ from its threefry draws).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sayuri_tpu_torch.game import board as B_
from sayuri_tpu_torch.game.analysis import score_ownership
from sayuri_tpu_torch.game.ladder import ladder_planes_batch
from sayuri_tpu_torch.game.state import GoEnv, GoState
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE
from sayuri_tpu_torch.mcts import gumbel as G
from sayuri_tpu_torch.mcts.core import MCTS


@dataclasses.dataclass(frozen=True)
class SelfplayConfig:
    """Self-play knobs, named like the JAX package's SelfplayConfig."""

    playouts: int = 150
    fastsearch_playouts: int = 50
    fastsearch_playouts_prob: float = 0.75
    resign_threshold: float = 0.1
    resign_playouts: int = 0
    resign_discard_prob: float = 0.8
    random_moves_factor: float = 0.0
    random_moves_temp: float = 1.0
    random_fastsearch_prob: float = 0.0
    # low-visit pruning of the proportional random move: keep children with
    # visits > max(round(max_visits * min_ratio), min_visits)
    random_min_ratio: float = 0.0
    random_min_visits: int = 1
    max_moves_factor: float = 1.8  # game length cap, in units of n*n
    # random opening sampling; prob < 0 = auto (0.75 when
    # random_moves_factor > 0)
    random_opening_prob: float = -1.0
    random_opening_temp: float = 1.2
    komi_stddev: float = 0.0
    komi_big_stddev: float = 0.0
    komi_big_stddev_prob: float = 0.0


class MoveRecord(NamedTuple):
    """Per-move training record (all [B, ...] tensors)."""

    states: GoState           # position BEFORE the move (superko ring cut)
    target_policy: torch.Tensor  # [B, A]
    q_value: torch.Tensor        # [B] side-to-move perspective
    score_lead: torch.Tensor     # [B] side-to-move perspective
    q_stddev: torch.Tensor       # [B]
    score_stddev: torch.Tensor   # [B]
    kld: torch.Tensor            # [B] policy surprise
    discard: torch.Tensor        # [B] bool
    move: torch.Tensor           # [B] chosen action
    active: torch.Tensor         # [B] game still running at this move
    visits: torch.Tensor         # [B] root children visit total


def _stddev(sq, root_v):
    var = torch.where(root_v > 1, sq / (root_v - 1).clamp(min=1), 1.0)
    return torch.sqrt(var.clamp(min=0.0))


class SelfplayActor:
    def __init__(self, env: GoEnv, mcts: MCTS, cfg: SelfplayConfig):
        self.env = env
        self.mcts = mcts
        self.cfg = cfg
        self.last_query_stats = None
        self.last_helper_steps = 0

    # ------------------------------------------------------------------

    def _target_policy(self, tree, visits_dist, children_visits):
        """Completed-Q target policy with damping + policy target pruning."""
        mcts = self.mcts
        cfg = mcts.cfg
        cq = G.completed_q_policy(mcts, tree)

        # PUCT lanes: damped mix + pruning
        damping = 800.0
        factor = (children_visits.to(torch.float32).clamp(max=damping) / damping
                  ).clamp(max=1.0)[:, None]
        mixed = factor * visits_dist + (1.0 - factor) * cq

        best = mixed.argmax(-1)
        vv = children_visits.clamp(min=3200).to(torch.float32)
        cpuct = cfg.cpuct_init + cfg.cpuct_base_factor * torch.log(
            (vv + cfg.cpuct_base + 1.0) / cfg.cpuct_base
        )
        prior = tree.prior[:, 0]
        color = tree.states.to_move[:, 0]
        q = mcts.root_child_q(tree, color)
        nv = mcts.root_child_visits(tree)
        net_wl = tree.stats[:, 0, 7]
        raw = torch.where(color == 0, net_wl, 1.0 - net_wl)
        est_q = torch.where(nv > 0, q, raw[:, None])
        best_q = est_q.gather(1, best[:, None])
        value_diff = best_q - est_q
        wanted_visits = (torch.round(
            cpuct[:, None] * prior * vv[:, None] / value_diff.clamp(min=1e-8)
        ) - 1.0).clamp(min=0.0)
        wanted_prob = wanted_visits / vv[:, None]
        not_best = torch.arange(visits_dist.shape[-1], device=best.device)[None] != best[:, None]
        pruned = torch.where((value_diff > 0) & not_best,
                             torch.minimum(mixed, wanted_prob), mixed)
        total = pruned.sum(-1, keepdim=True)
        puct_target = torch.where(total > 1e-4, pruned / total.clamp(min=1e-8),
                                  visits_dist)

        target = torch.where(tree.use_gumbel[:, None], cq, puct_target)
        # no visits at all: the raw visit distribution
        return torch.where((children_visits > 0)[:, None], target, visits_dist)

    def _forbid_pass(self, states, tree, raw_ownership):
        """[B] bool: should pass be forbidden at these roots (early in the
        game, or under the area rule while the position is unresolved)."""
        n = self.env.n
        b = states.stones.shape[0]
        nn_count = states.size * states.size
        early = states.move_count <= nn_count // 6

        safe_own = score_ownership(states.stones, states.size).reshape(b, -1)
        sign = torch.where(states.to_move == 0, 1, -1)[:, None]
        safe_mine = safe_own * sign
        mask = B_.board_mask(states.size, n).reshape(b, -1)

        # opponent stones the search's ownership calls mine, not safe-mine
        signf = sign.to(torch.float32)
        mcts_own_mine = tree.root_ownership * signf
        opp_stone = (states.stones.reshape(b, -1) == (2 - states.to_move)[:, None]) & mask
        dead_opp = (opp_stone & (mcts_own_mine > 0.75) & (safe_mine != 1)).any(-1)

        # area the raw net ownership calls mine, not safe-mine
        raw_dead = (mask & (raw_ownership * signf >= 0.8) & (safe_mine != 1)).any(-1)

        # a large undecided region (8 or more cells)
        neutral = (safe_own == 0) & mask
        lbl = B_.chain_labels(neutral.reshape(b, n, n)).reshape(b, -1)
        sizes = torch.zeros((b, n * n + 1), dtype=torch.int64, device=lbl.device)
        sizes.scatter_add_(1, torch.where(lbl >= 0, lbl, n * n), torch.ones_like(lbl))
        big_empty = (sizes[:, : n * n] >= 8).any(-1)

        is_area = states.rule == AREA_RULE
        return early | (is_area & (dead_opp | raw_dead | big_empty))

    def playout_cap(self, already_lost, gen):
        """Playout-cap randomization: ([B] bool fast-search lanes, [B]
        playout budgets). Lanes that already lost search fast more often."""
        cfg = self.cfg
        fast_prob = torch.where(
            already_lost,
            1.0 - (1.0 - cfg.fastsearch_playouts_prob) * (1.0 - cfg.resign_discard_prob),
            cfg.fastsearch_playouts_prob,
        )
        u = torch.rand(already_lost.shape, generator=gen, device=already_lost.device)
        use_fast = (u < fast_prob) & (0 < cfg.fastsearch_playouts < cfg.playouts)
        budget = torch.where(use_fast, cfg.fastsearch_playouts, cfg.playouts)
        if cfg.resign_playouts > 0:
            budget = torch.where(use_fast & already_lost,
                                 budget.clamp(max=cfg.resign_playouts), budget)
        return use_fast, budget

    def random_move(self, visits, forbid_pass, gen):
        """A move ~ visits^(1/temp) per lane ([B, A] float visits), the
        low-visit children pruned (the max-visit child kept if nothing is
        left), pass excluded where `forbid_pass`. Returns (move [B], has a
        candidate [B] bool)."""
        cfg = self.cfg
        vmax = visits.amax(-1, keepdim=True)
        min_v = torch.round(vmax * cfg.random_min_ratio).clamp(min=float(cfg.random_min_visits))
        logw = torch.where(visits > min_v,
                           torch.log(visits.clamp(min=1e-9)) / max(cfg.random_moves_temp, 1e-4),
                           -torch.inf)
        none_left = ~torch.isfinite(logw).any(-1, keepdim=True)
        logw = torch.where(none_left & (visits >= vmax) & (visits > 0), 0.0, logw)
        pass_col = torch.zeros_like(logw, dtype=torch.bool)
        pass_col[:, -1] = True
        logw = torch.where(forbid_pass[:, None] & pass_col, -torch.inf, logw)
        u = torch.rand(logw.shape, generator=gen, device=logw.device)
        move = (logw - torch.log(-torch.log(u.clamp(min=1e-20)))).argmax(-1)
        return move, torch.isfinite(logw).any(-1)

    @torch.no_grad()
    def move_step(self, states, gen, already_lost, prev_tree=None, prev_action=None):
        """One move for every game -> (new states, MoveRecord, already_lost,
        tree, move)."""
        env, mcts, cfg = self.env, self.mcts, self.cfg
        b = states.stones.shape[0]
        dev = states.stones.device

        use_fast, budget = self.playout_cap(already_lost, gen)
        use_noise = ~use_fast & mcts.cfg.dirichlet_noise
        use_gumbel = ~use_fast & mcts.cfg.gumbel

        # --- root superko purge, root ladder planes ---
        superko = env.superko_action_mask(states)
        ctx = {"ladders": ladder_planes_batch(states.stones, states.size, states.ko)}

        if prev_tree is None:
            tree = mcts.init_tree(states, gen, use_noise=use_noise, use_gumbel=use_gumbel,
                                  prior_mask=~superko, ctx=ctx)
        else:
            tree, _ = mcts.advance_root(prev_tree, prev_action, states, gen,
                                        use_noise=use_noise, use_gumbel=use_gumbel,
                                        prior_mask=~superko, ctx=ctx)
        raw_priors = tree.prior[:, 0]
        raw_nn_ownership = tree.root_ownership      # the net's before the sims
        # visit-cap semantics under reuse: top the root up to the budget
        budget_eff = (budget - (tree.visits[:, 0] - 1)).clamp(min=0)
        tree = mcts.run(tree, cfg.playouts, budget=budget_eff, ctx=ctx)

        # --- root stats ---
        root_v = tree.visits[:, 0].clamp(min=1)
        root_wl_b = tree.stats[:, 0, 1] / root_v
        root_score_b = tree.stats[:, 0, 3] / root_v
        black = states.to_move == 0
        root_wl_stm = torch.where(black, root_wl_b, 1.0 - root_wl_b)
        root_score_stm = torch.where(black, root_score_b, -root_score_b)
        q_stddev = _stddev(tree.stats[:, 0, 4], root_v)
        score_stddev = _stddev(tree.stats[:, 0, 5], root_v)

        # --- move selection ---
        forbid_pass = self._forbid_pass(states, tree, raw_nn_ownership)
        allow_pass = ~forbid_pass
        best = mcts.best_move(tree, allow_pass=allow_pass)
        gmove = G.gumbel_move(mcts, tree, allow_pass=allow_pass)
        move = torch.where(use_gumbel, gmove, best)

        child_visits = mcts.root_child_visits(tree)
        visits = child_visits.to(torch.float32)
        u_rand = torch.rand((b,), generator=gen, device=dev)
        rand_move, has_rand = self.random_move(visits, forbid_pass, gen)
        nn_count = (states.size * states.size).to(torch.float32)
        opening = states.move_count < (cfg.random_moves_factor * nn_count).to(torch.int32)
        use_rand = (opening & ~use_gumbel) | (
            ~already_lost & use_fast & (u_rand < cfg.random_fastsearch_prob)
        )
        move = torch.where(use_rand & has_rand, rand_move, move)

        # --- training record ---
        children_visits = child_visits.sum(-1)
        visits_dist = visits / visits.sum(-1, keepdim=True).clamp(min=1.0)
        target = self._target_policy(tree, visits_dist, children_visits)
        kld = torch.where(
            target > 0,
            target * torch.log(target.clamp(min=1e-25) / raw_priors.clamp(min=1e-25)),
            0.0,
        ).sum(-1)

        # --- resign bookkeeping ---
        lost_now = ((root_wl_stm < cfg.resign_threshold)
                    | (root_wl_stm > 1.0 - cfg.resign_threshold))
        new_lost = already_lost | (lost_now & ~use_fast)

        record = MoveRecord(
            states=states.replace(hash_history=states.hash_history[:, :1]),
            target_policy=target,
            q_value=root_wl_stm,
            score_lead=root_score_stm,
            q_stddev=q_stddev,
            score_stddev=score_stddev,
            kld=kld,
            discard=use_fast,
            move=move,
            active=~states.terminated,
            visits=children_visits.to(torch.int32),
        )
        new_states, _ = env.step_batch_with_analysis(states, move)
        return new_states, record, new_lost, tree, move

    # ------------------------------------------------------------------
    # territory-rule dead-stone labelling
    # ------------------------------------------------------------------

    @torch.no_grad()
    def playout_step(self, states, gen):
        """One fast no-exploring move for the territory-helper playout;
        forbid-pass keeps lanes capturing dead stones until the position is
        resolved, then the games end by two passes."""
        env, mcts, cfg = self.env, self.mcts, self.cfg
        b = states.stones.shape[0]
        superko = env.superko_action_mask(states)
        ctx = {"ladders": ladder_planes_batch(states.stones, states.size, states.ko)}
        off = torch.zeros((b,), dtype=torch.bool, device=states.stones.device)
        tree = mcts.init_tree(states, gen, use_noise=off, use_gumbel=off,
                              prior_mask=~superko, ctx=ctx)
        playouts = (cfg.fastsearch_playouts if 0 < cfg.fastsearch_playouts < cfg.playouts
                    else cfg.playouts)
        tree = mcts.run(tree, playouts, ctx=ctx)
        forbid = self._forbid_pass(states, tree, tree.root_ownership)
        move = mcts.best_move(tree, allow_pass=~forbid)
        new_states, _ = env.step_batch_with_analysis(states, move)
        return new_states

    def territory_playout(self, final_states: GoState, gen, max_steps: int | None = None):
        """[B, n, n] territory-helper ownership for a finished batch.

        Territory-rule lanes resume the ended game (two passes leave board
        and side to move unchanged), switch to area scoring with the
        score-preserving komi offset, play on with fast no-exploring
        searches until every dead string is captured, and give the end
        position's score-area ownership. Area-rule lanes stay frozen and
        their helper slots are unused."""
        env = self.env
        terr = final_states.rule == TERRITORY_RULE
        self.last_helper_steps = 0
        if not bool(terr.any()):
            return score_ownership(final_states.stones, final_states.size)
        if max_steps is None:
            max_steps = env.n * env.n
        offset = env.penalty_offset_to_area(final_states)
        states = final_states.replace(
            terminated=torch.where(terr, False, final_states.terminated),
            pass_count=torch.where(terr, 0, final_states.pass_count).to(torch.int32),
            rule=torch.where(terr, AREA_RULE, final_states.rule).to(torch.int32),
            komi=torch.where(terr, final_states.komi + offset, final_states.komi),
        )
        for _ in range(max_steps):
            states = self.playout_step(states, gen)
            self.last_helper_steps += 1
            if bool(states.terminated.all()):
                break
        return score_ownership(states.stones, states.size)

    # ------------------------------------------------------------------

    def play_games(self, states: GoState, gen, max_moves: int | None = None):
        """Play all B games to completion (or the move cap), each move's
        tree reused by the next (the reference's visit-cap mode); returns
        (final_states, list[MoveRecord]). The NN cache rides with the tree,
        and its counters are read once, at the end, into
        `last_query_stats`."""
        env, cfg = self.env, self.cfg
        if max_moves is None:
            max_moves = int(cfg.max_moves_factor * env.n * env.n)
        b = states.stones.shape[0]
        already_lost = torch.zeros((b,), dtype=torch.bool, device=states.stones.device)
        records = []
        tree = move = None
        for _ in range(max_moves):
            states, rec, already_lost, tree, move = self.move_step(
                states, gen, already_lost, tree, move)
            records.append(rec)
            if bool(states.terminated.all()):
                break
        c = tree.cache
        q = ([0, 0, 0] if c is None else
             torch.stack([c.queries.sum(), c.hits.sum(), c.dups.sum()]).tolist())
        self.last_query_stats = dict(queries=q[0], hits=q[1], dups=q[2])
        return states, records


# ----------------------------------------------------------------------
# post-game target assembly
# ----------------------------------------------------------------------

@torch.no_grad()
def assemble_targets(env: GoEnv, final_states: GoState, records, territory_helper=None):
    """Game-outcome training targets for a finished batch: a dict of
    [T, B, ...] tensors aligned with `records` (result, final_score,
    ownership (stm), avg/short/middle/long q and score, aux_policy) plus
    [B] winner and end. `territory_helper` ([B, n, n] from
    SelfplayActor.territory_playout) marks dead stones for territory-rule
    lanes."""
    T = len(records)
    b = final_states.stones.shape[0]
    A = records[0].target_policy.shape[-1]
    hw = env.n * env.n
    dev = final_states.stones.device

    stm = torch.stack([r.states.to_move for r in records])       # [T, B]
    q = torch.stack([r.q_value for r in records])
    score = torch.stack([r.score_lead for r in records])
    active = torch.stack([r.active for r in records])

    if territory_helper is not None:
        black_final = env.final_score_with_helper(final_states, territory_helper)
        own_black = env.ownership_with_helper(final_states, territory_helper)
    else:
        black_final = env.final_score(final_states)
        own_black = env.ownership(final_states)
    own_black = own_black.reshape(b, hw).to(torch.float32)
    winner = torch.where(black_final.abs() < 1e-4, 0,
                         torch.where(black_final > 0, 1, -1))

    sign_stm = torch.where(stm == 0, 1.0, -1.0)
    w = winner[None]
    result = torch.where(w == 0, 0.0, torch.where(w == 1, sign_stm, -sign_stm))
    final_score_stm = torch.where(w == 0, 0.0, sign_stm * black_final[None])
    ownership_stm = own_black[None] * sign_stm[..., None]         # [T, B, HW]

    end = active.to(torch.int64).sum(0)                           # [B]

    # windowed average Q / score over +-half moves inside each game
    half = max(3, env.n // 2)
    q_b, s_b = q * sign_stm, score * sign_stm
    idx = torch.arange(T, device=dev)
    offs = torch.arange(-half, half + 1, device=dev)
    win_idx = idx[:, None] + offs[None, :]                         # [T, W]
    valid = (win_idx >= 0)[..., None] & (win_idx[..., None] < end[None, None, :])
    win_c = win_idx.clamp(0, T - 1)
    cnt = valid.sum(1).clamp(min=1)
    avg_q_b = torch.where(valid, q_b[win_c], 0.0).sum(1) / cnt
    avg_s_b = torch.where(valid, s_b[win_c], 0.0).sum(1) / cnt

    # short/middle/long-term values: forward-fill past each game's end,
    # then the backward recursion acc_t = (1-lam)*avg_t + lam*acc_{t+1}
    clamp_t = torch.minimum(idx[:, None], (end - 1).clamp(min=0)[None, :])
    q_fill = avg_q_b.gather(0, clamp_t)
    s_fill = avg_s_b.gather(0, clamp_t)
    nn_count = (final_states.size * final_states.size).to(torch.float32)
    out = {}
    for name, coef in (("short", 0.18), ("middle", 0.06), ("long", 0.02)):
        lam = 1.0 / (1.0 + nn_count * coef)
        acc_q, acc_s = q_fill[-1], s_fill[-1]
        dq, ds = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            acc_q = (1.0 - lam) * q_fill[t] + lam * acc_q
            acc_s = (1.0 - lam) * s_fill[t] + lam * acc_s
            dq[t], ds[t] = acc_q, acc_s
        out[f"{name}_q"] = torch.stack(dq) * sign_stm
        out[f"{name}_score"] = torch.stack(ds) * sign_stm

    # aux policy: the next move's target; the game's last row gets pass
    pass_onehot = torch.zeros((b, A), device=dev)
    pass_onehot[:, A - 1] = 1.0
    aux = torch.stack([r.target_policy for r in records[1:]] + [pass_onehot])
    is_last = idx[:, None] == (end - 1)[None, :]
    aux = torch.where(is_last[..., None], pass_onehot[None], aux)

    return dict(
        result=result,
        final_score=final_score_stm,
        ownership=ownership_stm,
        avg_q=avg_q_b * sign_stm,
        avg_score=avg_s_b * sign_stm,
        aux_policy=aux,
        winner=winner,
        end=end,
        **out,
    )
