"""Array-based batched MCTS (PyTorch port of sayuri_tpu.mcts.core).

The forest of B independent game trees lives in dense tensors
``[B, max_nodes + 1, ...]`` and one simulation per tree advances in
lockstep:

    select (vectorized PUCT descent)  ->  fused step + analysis kernel
    ->  ONE batched network forward over all B leaves  ->  scatter backup

Row ``max_nodes`` of every node array is a scratch row: masked-out
expansions and backups write there instead of being dropped (the JAX
package scatters out of bounds with mode="drop"), so no step needs a
host sync. The descent is a Python loop that syncs once per depth level.

Ported search semantics: PUCT with FPU reduction, dynamic cpuct scaled by
the child value variance, log-growth cpuct, the score-utility term
E[atan((s - center)/(div*bsize))]*2/pi by Gauss-Hermite quadrature, forced
playouts at the root, Dirichlet root noise, Gumbel / Sequential-Halving
root selection (mcts/gumbel.py), per-lane playout budgets (lanes past
their budget are frozen), the shared NN evaluation cache
(mcts/nncache.py), tree reuse across moves (``advance_root``), Welford
variance for WL and score, terminal two-pass leaves valued by the final
score, exact-tie PUCT resolution to the highest prior, and LCB best-move
selection with the self-play forbid-pass mask, a root evaluator of its
own (``root_eval_fn``: the GTP engine's root temperature and policy head,
never cached), the first-pass score bonus (``first_pass_bonus``: seki and
ownership at every expansion, folded into the score mean at backup) and
the plain Tromp-Taylor scoring of terminal leaves (``terminal_tt_score``).

Random draws (Dirichlet noise, Gumbel noise) come from the
``torch.Generator`` handed to ``init_tree``, kept in the tree: the JAX
package folds threefry keys by simulation index instead, so the two give
different numbers for the same seed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from sayuri_tpu_torch import telemetry as T
from sayuri_tpu_torch.game.state import GoEnv, GoState


class NetEvals(NamedTuple):
    """Evaluation of a batch of states, black perspective."""

    priors: torch.Tensor          # [B, A] legal-masked softmax policy
    black_wl: torch.Tensor        # [B] P(black wins) in [0, 1]
    draw: torch.Tensor            # [B]
    black_score: torch.Tensor     # [B] predicted black score lead
    black_ownership: torch.Tensor  # [B, HW] in [-1, 1]


# eval_fn(states, ctx) -> NetEvals; `ctx` is a per-search dict (root ladder
# planes, the fused kernel's analysis) or None
EvalFn = Callable[[GoState, Any], NetEvals]


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search knobs, named like the JAX package's SearchConfig."""

    max_nodes: int = 256
    max_depth: int = 96
    # PUCT
    cpuct_init: float = 0.5
    cpuct_base: float = 19652.0
    cpuct_base_factor: float = 1.0
    cpuct_dynamic: bool = True
    cpuct_dynamic_k_factor: float = 4.0
    cpuct_dynamic_k_base: float = 10000.0
    fpu_reduction: float = 0.25
    root_fpu_reduction: float = 0.25
    # score utility
    score_utility_factor: float = 0.4
    score_utility_div: float = 1.0
    forced_playouts_k: float = 0.0
    # noise / exploration
    dirichlet_noise: bool = False
    dirichlet_epsilon: float = 0.25
    dirichlet_init: float = 0.03
    dirichlet_factor: float = 361.0
    # Gumbel root
    gumbel: bool = False
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0
    gumbel_considered_moves: int = 16
    gumbel_prom_visits: int = 1
    gumbel_playouts_threshold: int = 400
    # fresh Gumbel noise at every root selection and at the move pick;
    # False draws once a search (Tree.root_gumbel), as the original
    # Gumbel-AlphaZero does
    gumbel_per_selection: bool = True
    # LCB best-move selection
    lcb_reduction: float = 0.02
    ci_alpha: float = 1e-5
    # NN eval cache sets (2 ways each, shared by all lanes); 0 disables
    nn_cache_size: int = 0
    # endgame score bonus: pass and seki / dame points under the area rule,
    # pass and filling one's own territory penalized under the territory
    # rule (MCTS._score_bonus); off by default
    first_pass_bonus: bool = False
    # value terminal two-pass leaves by the plain Tromp-Taylor reach
    # ownership instead of the score area with the pass-alive override
    terminal_tt_score: bool = False


@dataclasses.dataclass
class Tree:
    """Forest of B trees; node 0 of each tree is its root (tree reuse
    re-roots by copying the kept subtree forward) and node ``max_nodes`` is
    the scratch row."""

    prior: torch.Tensor          # [B, N+1, A] f32, 0 for illegal actions
    child: torch.Tensor          # [B, N+1, A] int64 node index or -1
    parent: torch.Tensor         # [B, N+1] int64 (-1 for the root)
    # packed per-node stats [B, N+1, 8] f32:
    #   0 visits, 1 acc_wl (black), 2 acc_draw, 3 acc_score (black),
    #   4 sq_eval_diff, 5 sq_score_diff (Welford), 6 score_eval cache
    #   (black), 7 net_wl (black)
    stats: torch.Tensor
    terminal: torch.Tensor       # [B, N+1] bool
    # first-pass-bonus score offset of the move leading to the node (black's
    # view); all zero unless cfg.first_pass_bonus
    black_sb: torch.Tensor       # [B, N+1] f32
    states: GoState              # per-node states, leading dims [B, N+1]
    next_free: torch.Tensor      # [B] int64
    root_noise: torch.Tensor     # [B, A] Dirichlet noise
    root_ownership: torch.Tensor  # [B, HW] running average
    score_center: torch.Tensor   # [B] frozen score-utility center
    use_noise: torch.Tensor      # [B] bool per-lane Dirichlet switch
    use_gumbel: torch.Tensor     # [B] bool per-lane Gumbel switch
    cache: Any = None            # mcts/nncache.NNCache or None
    gen: Any = None              # torch.Generator of the search's draws
    # [B, A] the search's one Gumbel draw (-inf off the legal moves) when
    # cfg.gumbel_per_selection is False, else None
    root_gumbel: Any = None

    @property
    def visits(self):
        return self.stats[..., 0].to(torch.int32)

    @property
    def num_actions(self) -> int:
        return self.prior.shape[-1]


# Gauss-Hermite nodes/weights for E[f(mean + stddev*Z)], Z ~ N(0,1)
_GH_X, _GH_W = np.polynomial.hermite_e.hermegauss(11)
_GH_W = _GH_W / _GH_W.sum()


def _norm_to_t_approx(z, dof):
    """Normal quantile -> Student-t quantile approximation."""
    dof = np.asarray(dof, np.float64)
    n_hi = np.maximum(dof + 1.0, 2.0)
    n_lo = dof + 2.0
    hi = np.sqrt(
        n_hi * np.exp(z * z * (n_hi - 1.5) / ((n_hi - 1.0) * (n_hi - 1.0)))
        - n_hi
    )
    lo = np.sqrt(
        n_lo
        * np.exp(
            z * z * (n_lo - 0.853999327911)
            / ((n_lo - 1.044042304114) * (n_lo - 0.954115472059))
        )
        - n_lo
    )
    return np.where(dof > 8, hi, lo)


@functools.lru_cache(maxsize=None)
def _make_lcb_z_table(ci_alpha=1e-5, size=1000):
    """Entry i = t-quantile at dof i for complement probability ci_alpha."""
    from scipy.stats import norm

    z = float(norm.ppf(1.0 - ci_alpha))
    return _norm_to_t_approx(z, np.arange(size)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _consts(device: str):
    return (torch.tensor(_GH_X, dtype=torch.float32, device=device),
            torch.tensor(_GH_W, dtype=torch.float32, device=device))


def expected_score_value(mean, stddev, center, div, board_size):
    """E[atan((s - center)/(div*bsize))*2/pi], s ~ N(mean, stddev)."""
    gx, gw = _consts(str(mean.device))
    x = mean[..., None] + stddev[..., None] * gx
    sv = torch.atan((x - center[..., None]) / (div * board_size)) * (2.0 / np.pi)
    return (sv * gw).sum(-1)


class MCTS:
    """Batched search driver bound to an env + eval function."""

    def __init__(self, env: GoEnv, eval_fn: EvalFn, cfg: SearchConfig,
                 root_eval_fn: EvalFn | None = None):
        self.env = env
        self.eval_fn = eval_fn
        # the root may be evaluated with another head / temperature than the
        # leaves; such a root evaluation bypasses the NN cache, so that the
        # cache only ever holds leaf evaluations
        self.root_eval_fn = root_eval_fn
        self.cfg = cfg
        self.A = env.num_actions

    # ------------------------------------------------------------------
    # tree construction
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init_tree(self, root_states: GoState, gen=None, use_noise=None,
                  use_gumbel=None, prior_mask=None, ctx=None, cache=None) -> Tree:
        """Evaluate the roots and build a fresh forest. `gen`: the
        torch.Generator of the search's draws (a fresh one seeded 0 when
        None). `use_noise` / `use_gumbel`: [B] bool per-lane overrides of the
        config flags (fast-search lanes explore with neither). `prior_mask`
        ([B, A] bool) zeroes root priors (the root superko purge) and
        renormalizes. `cache`: the NN cache to evaluate through (a new one
        when None and cfg.nn_cache_size > 0)."""
        from sayuri_tpu_torch.mcts import nncache as NC

        cfg = self.cfg
        b = root_states.stones.shape[0]
        dev = root_states.stones.device
        rows, A = cfg.max_nodes + 1, self.A
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)

        if cache is None and cfg.nn_cache_size > 0:
            cache = NC.make_cache(b, cfg.nn_cache_size, A, self.env.n ** 2, device=dev)
        if self.root_eval_fn is not None:
            evals = self.root_eval_fn(root_states, ctx)
        elif cache is not None:
            evals, cache = NC.cached_eval(cache, self.eval_fn, root_states, ctx)
        else:
            evals = self.eval_fn(root_states, ctx)
        if prior_mask is not None:
            priors = torch.where(prior_mask, evals.priors, 0.0)
            priors = priors / priors.sum(-1, keepdim=True).clamp(min=1e-12)
            evals = evals._replace(priors=priors)

        # tree nodes never consult the superko ring: keep a length-1 stub
        slim = root_states.replace(hash_history=root_states.hash_history[:, :1])

        def node_buf(x):
            buf = torch.zeros((b, rows) + x.shape[1:], dtype=x.dtype, device=dev)
            buf[:, 0] = x
            return buf

        noise = self._sample_dirichlet(gen, evals.priors)
        gumbel = None if cfg.gumbel_per_selection else self._sample_gumbel(gen, evals.priors)
        root_se = expected_score_value(
            evals.black_score, torch.ones_like(evals.black_score),
            evals.black_score, cfg.score_utility_div, float(self.env.n),
        ) * cfg.score_utility_factor
        zb = torch.zeros_like(evals.black_wl)
        root_stats = torch.stack(
            [torch.ones_like(zb), evals.black_wl, evals.draw, evals.black_score,
             zb, zb, root_se, evals.black_wl], -1,
        )
        stats = torch.zeros((b, rows, 8), device=dev)
        stats[:, 0] = root_stats
        prior = torch.zeros((b, rows, A), device=dev)
        prior[:, 0] = evals.priors
        terminal = torch.zeros((b, rows), dtype=torch.bool, device=dev)
        terminal[:, 0] = root_states.terminated

        def lane_flag(flag, default):
            if flag is None:
                return torch.full((b,), default, dtype=torch.bool, device=dev)
            return flag.to(device=dev, dtype=torch.bool)

        return Tree(
            prior=prior,
            child=torch.full((b, rows, A), -1, dtype=torch.int64, device=dev),
            parent=torch.full((b, rows), -1, dtype=torch.int64, device=dev),
            stats=stats,
            terminal=terminal,
            black_sb=torch.zeros((b, rows), device=dev),
            states=slim.map(node_buf),
            next_free=torch.ones((b,), dtype=torch.int64, device=dev),
            root_noise=noise,
            root_ownership=evals.black_ownership.clone(),
            score_center=evals.black_score.clone(),
            use_noise=lane_flag(use_noise, cfg.dirichlet_noise),
            use_gumbel=lane_flag(use_gumbel, cfg.gumbel),
            cache=cache,
            gen=gen,
            root_gumbel=gumbel,
        )

    def _sample_gumbel(self, gen, priors):
        """[B, A] one Gumbel draw for the whole search: standard Gumbel
        noise on the legal moves, -inf elsewhere; zeros with Gumbel off."""
        if not self.cfg.gumbel:
            return torch.zeros_like(priors)
        g = sample_gumbel(priors.shape, gen)
        return torch.where(priors > 0, g, -torch.inf)

    def _sample_dirichlet(self, gen, priors):
        """[B, A] root Dirichlet buffer: alpha = dirichlet_init *
        dirichlet_factor / (number of legal moves) over the legal moves."""
        cfg = self.cfg
        if not cfg.dirichlet_noise:
            return torch.zeros_like(priors)
        legal = priors > 0
        num_legal = legal.sum(-1, keepdim=True).clamp(min=1)
        alpha = (cfg.dirichlet_init * cfg.dirichlet_factor / num_legal).expand_as(priors)
        g = torch.where(legal, sample_gamma(alpha, gen), 0.0)
        return g / g.sum(-1, keepdim=True).clamp(min=1e-12)

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------

    @staticmethod
    def _child_stats(tree, node_idx=None):
        """([B, A, 8] stats of each action's child node, [B, A] child-exists
        mask), zeros where no child. `node_idx=None` is the root."""
        b = tree.stats.shape[0]
        b_idx = torch.arange(b, device=tree.stats.device)
        ch = tree.child[:, 0] if node_idx is None else tree.child[b_idx, node_idx]
        has = ch >= 0
        g = tree.stats[b_idx[:, None], ch.clamp(min=0)]
        return torch.where(has[..., None], g, 0.0), has

    def _puct_scores(self, tree, node_idx, is_root: bool, color=None):
        """[B, A] PUCT selection scores at `node_idx` (None = the root)."""
        cfg = self.cfg
        b = tree.stats.shape[0]
        b_idx = torch.arange(b, device=tree.stats.device)
        if node_idx is None:
            p_raw = tree.prior[:, 0]
            g, _ = self._child_stats(tree)
            node_row = tree.stats[:, 0]
            if color is None:
                color = tree.states.to_move[:, 0]
        else:
            p_raw = tree.prior[b_idx, node_idx]
            g, _ = self._child_stats(tree, node_idx)
            node_row = tree.stats[b_idx, node_idx]
            if color is None:
                color = tree.states.to_move[b_idx, node_idx]
        legal = p_raw > 0

        nv = g[..., 0]
        wl_sum = g[..., 1]
        se_b = g[..., 6]
        ch_var = torch.where(nv > 1.0, g[..., 4] / (nv - 1.0).clamp(min=1.0), 1.0)
        k_raw = torch.clamp(
            cfg.cpuct_dynamic_k_factor * torch.sqrt(ch_var.clamp(min=0.0))
            / nv.clamp(min=1.0),
            0.5, 1.4,
        )
        cv = nv.sum(-1)
        tvp = torch.where(nv > 0, p_raw, 0.0).sum(-1)

        black = color == 0
        sign = torch.where(black, 1.0, -1.0)

        parent_v = node_row[:, 0]
        node_net_wl = node_row[:, 7]
        node_wl = node_row[:, 1] / parent_v.clamp(min=1.0)
        net_wl_c = torch.where(black, node_net_wl, 1.0 - node_net_wl)
        wl_c = torch.where(black, node_wl, 1.0 - node_wl)
        fpu_red = (
            cfg.root_fpu_reduction if is_root else cfg.fpu_reduction
        ) * torch.sqrt(tvp)
        avg_factor = torch.square(tvp)
        fpu = torch.where(
            parent_v <= 0,
            net_wl_c - fpu_red,
            (1.0 - avg_factor) * net_wl_c + avg_factor * wl_c - fpu_red,
        )

        wl_child_b = wl_sum / nv.clamp(min=1.0)
        wl_child = torch.where(black[:, None], wl_child_b, 1.0 - wl_child_b)
        score_eval = sign[:, None] * se_b
        visited = nv > 0
        q = torch.where(visited, wl_child + score_eval, fpu[:, None])

        if cfg.forced_playouts_k > 0 and is_root:
            forced_n = torch.floor(torch.sqrt(torch.clamp(
                cfg.forced_playouts_k * torch.clamp(p_raw, max=0.2) * cv[:, None],
                min=1e-4,
            )))
            q = q + torch.where(visited & (forced_n > nv), (forced_n - nv) * 1e6, 0.0)

        # policy with root noise
        if cfg.dirichlet_noise and is_root:
            psa = torch.where(
                tree.use_noise[:, None],
                p_raw * (1 - cfg.dirichlet_epsilon) + cfg.dirichlet_epsilon * tree.root_noise,
                p_raw,
            )
        else:
            psa = p_raw

        cpuct = cfg.cpuct_init + cfg.cpuct_base_factor * torch.log(
            (cv + cfg.cpuct_base + 1.0) / cfg.cpuct_base
        )
        if cfg.cpuct_dynamic:
            alpha = 1.0 / (1.0 + torch.sqrt(cv[:, None] / cfg.cpuct_dynamic_k_base))
            k = alpha * k_raw + (1.0 - alpha)
            k = torch.where(nv > 1, k, 1.0)
            cpuct_a = cpuct[:, None] * k
        else:
            cpuct_a = cpuct[:, None].expand_as(p_raw)

        numerator = torch.sqrt(cv)
        puct = cpuct_a * psa * (numerator[:, None] / (1.0 + nv))
        return torch.where(legal, q + puct, -torch.inf)

    @staticmethod
    def _argmax_prior_tiebreak(scores, priors):
        """[B] argmax of `scores` with exact ties resolved to the
        highest-prior action, then the lowest action index (the reference
        walks children in descending-policy order with a strict `>`)."""
        m = scores.max(-1, keepdim=True).values
        return torch.where(scores >= m, priors, -torch.inf).argmax(-1)

    def _select_action(self, tree, node_idx, is_root, sim_idx=None, color=None):
        """PUCT everywhere; the Gumbel-SH root selection at the root of the
        lanes with use_gumbel (PUCT where its budget is exhausted)."""
        scores = self._puct_scores(tree, node_idx, is_root, color=color)
        if node_idx is None:
            priors = tree.prior[:, 0]
        else:
            b_idx = torch.arange(scores.shape[0], device=scores.device)
            priors = tree.prior[b_idx, node_idx]
        if self.cfg.gumbel and is_root:
            from sayuri_tpu_torch.mcts import gumbel as G

            g_scores = G.root_scores(self, tree, sim_idx=sim_idx)
            g_ok = torch.isfinite(g_scores).any(-1)
            scores = torch.where((tree.use_gumbel & g_ok)[:, None], g_scores, scores)
        return self._argmax_prior_tiebreak(scores, priors)

    # ------------------------------------------------------------------
    # one simulation for the whole batch
    # ------------------------------------------------------------------

    @torch.no_grad()
    def simulate(self, tree: Tree, sim_idx=0, active=None, ctx=None) -> Tree:
        """One playout per tree; updates `tree` in place and returns it.
        `sim_idx` tags the simulation (its Gumbel draw); `active` ([B]
        bool, all when None): lanes past their playout budget are frozen.
        Each stage is a span of the recorder (`telemetry`), a profiler
        range of the same name (`mcts.*`) while the profiler is on."""
        from sayuri_tpu_torch.mcts import nncache as NC

        b_idx = torch.arange(tree.stats.shape[0], device=tree.stats.device)
        if active is None:
            active = torch.ones_like(tree.terminal[:, 0])
        with T.span("mcts.descent"):
            path, leaf_parent, leaf_action = self._descend(tree, b_idx, sim_idx)
        with T.span("mcts.step_analysis"):
            parent_states = tree.states.map(lambda x: x[b_idx, leaf_parent])
            child_states, analysis = self.env.step_batch_with_analysis(
                parent_states, leaf_action
            )
        with T.span("mcts.evaluate"):
            eval_ctx = dict(ctx or {}, analysis=analysis)
            if tree.cache is not None:
                evals, tree.cache = NC.cached_eval(
                    tree.cache, self.eval_fn, child_states, eval_ctx,
                    live=active & ~child_states.terminated,
                )
            else:
                evals = self.eval_fn(child_states, eval_ctx)
            leaf = self._leaf_values(child_states, analysis, evals)
        with T.span("mcts.expand_backup"):
            if self.cfg.first_pass_bonus:
                # the bonus reads the root ownership before this backup
                # updates it
                sb = self._score_bonus(parent_states, leaf_action, tree.root_ownership)
            else:
                sb = None
            self._expand_backup(tree, b_idx, path, leaf_parent, leaf_action,
                                child_states, evals, leaf, active, sb)
        return tree

    def _descend(self, tree, b_idx, sim_idx=None):
        """PUCT descent for every lane; depth 0 is hoisted (every lane is at
        the root there). Returns (path [B, D], leaf parent, leaf action)."""
        cfg = self.cfg
        b, dev = b_idx.shape[0], b_idx.device
        path = torch.full((b, cfg.max_depth), -1, dtype=torch.int64, device=dev)
        path_a = path.clone()
        done = tree.terminal[:, 0]
        a0 = self._select_action(tree, None, True, sim_idx)
        path[:, 0] = torch.where(done, -1, 0)
        path_a[:, 0] = torch.where(done, -1, a0)
        child0 = tree.child[b_idx, 0, a0]
        child0_term = (child0 >= 0) & tree.terminal[b_idx, child0.clamp(min=0)]
        done = done | (child0 < 0) | child0_term
        cur = torch.where(done, 0, child0.clamp(min=0))
        root_color = tree.states.to_move[:, 0].to(torch.int64)
        depth = 1
        syncs = 0
        while depth < cfg.max_depth:
            # the descent's one host sync a level; the span holds the wait
            # for the card and the copy back, no launch
            syncs += 1
            pending = (~done).any()
            with T.span("mcts.descent.sync"):
                more = bool(pending)
            if not more:
                break
            # to_move alternates every ply (pass included)
            color = root_color ^ (depth & 1)
            scores = self._puct_scores(tree, cur, False, color=color)
            a = self._argmax_prior_tiebreak(scores, tree.prior[b_idx, cur])
            child = tree.child[b_idx, cur, a]
            path[:, depth] = torch.where(done, -1, cur)
            path_a[:, depth] = torch.where(done, -1, a)
            child_term = (child >= 0) & tree.terminal[b_idx, child.clamp(min=0)]
            new_done = done | (child < 0) | child_term
            cur = torch.where(new_done, cur, child.clamp(min=0))
            done = new_done
            depth += 1
        T.count("descent_syncs", syncs)

        # leaf edge = last recorded (node, action) per lane
        last_d = ((path >= 0).sum(-1) - 1).clamp(min=0)
        leaf_parent = torch.where(tree.terminal[:, 0], 0, path[b_idx, last_d])
        leaf_parent = leaf_parent.clamp(min=0)
        leaf_action = path_a[b_idx, last_d].clamp(min=0)
        return path, leaf_parent, leaf_action

    def _leaf_values(self, child_states, analysis, evals):
        """(black_wl, black_score, black_own, draw) of the leaves: the net's
        evaluation, or the final score for terminal two-pass leaves."""
        term = child_states.terminated
        key = "ownership" if self.cfg.terminal_tt_score else "score_ownership"
        own_map = analysis[key].reshape(term.shape[0], -1)
        t_score = (own_map.sum(-1).to(torch.float32)
                   - self.env.komi_with_penalty(child_states))
        own_map = own_map.to(torch.float32)
        t_wl = torch.where(t_score > 0, 1.0, torch.where(t_score < 0, 0.0, 0.5))
        black_wl = torch.where(term, t_wl, evals.black_wl)
        black_score = torch.where(term, t_score, evals.black_score)
        black_own = torch.where(term[:, None], own_map, evals.black_ownership)
        draw = torch.where(term, 0.0, evals.draw)
        return black_wl, black_score, black_own, draw

    def _score_bonus(self, parent_states, action, root_own):
        """[B] black-view score bonus of playing `action` from
        `parent_states`. Under the area rule a pass, a seki point, or a
        point the mover owns strongly (> 0.8) next to an opponent stone
        gets +0.5; under the territory rule a pass gets -1/3 and a point
        owned beyond 0.8 by either side a penalty rising to -0.5. No bonus
        while a ko is pending. As in the JAX package, the ownership is the
        tree's running root average, not the parent node's own."""
        from sayuri_tpu_torch.game import analysis as GA
        from sayuri_tpu_torch.game.types import AREA_RULE

        n = self.env.n
        nn = n * n
        b = action.shape[0]
        b_idx = torch.arange(b, device=action.device)
        thr, tail, end_bonus = 0.8, 0.2, 0.5
        color = parent_states.to_move                     # mover
        is_pass = action >= nn
        v = action.to(torch.int64).clamp(0, nn - 1)
        own_at = root_own[b_idx, v]                       # black view

        seki = GA.seki_at(parent_states.stones, parent_states.size, v)
        opp = (2 - color).to(parent_states.stones.dtype)   # opponent stone value
        st = parent_states.stones.reshape(b, nn)
        nbr_opp = torch.zeros_like(is_pass)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            y, x = v // n + dy, v % n + dx
            ok = (y >= 0) & (y < n) & (x >= 0) & (x < n)
            nbr_opp = nbr_opp | (ok & (st[b_idx, (y * n + x).clamp(0, nn - 1)] == opp))

        own_sign = torch.where(color == 0, own_at, -own_at)   # mover view
        area_pt = seki | ((own_sign > thr) & nbr_opp)
        area_bonus = torch.where(is_pass | area_pt, end_bonus, 0.0)
        penal = (own_at.abs() - thr).clamp(min=0.0) / tail
        terr_bonus = torch.where(is_pass, -(2.0 / 3.0) * end_bonus, -penal * end_bonus)
        bonus = torch.where(parent_states.rule == AREA_RULE, area_bonus, terr_bonus)
        bonus = torch.where(color == 0, bonus, -bonus)       # black view
        return torch.where(parent_states.ko >= 0, 0.0, bonus)

    def _expand_backup(self, tree, b_idx, path, leaf_parent, leaf_action,
                       child_states, evals, leaf, active, sb=None):
        """Expand the leaf (unless the child exists, the tree is full, the
        root is terminal or the lane is frozen), then back up along the path
        + the leaf with one gather and one scatter. `sb`: the first-pass
        bonus of the leaf's move, written with the expansion and folded into
        the score mean of every updated node."""
        cfg = self.cfg
        n_nodes = cfg.max_nodes
        black_wl, black_score, black_own, draw = leaf
        term = child_states.terminated
        existing_child = tree.child[b_idx, leaf_parent, leaf_action]
        new_idx = tree.next_free
        reuse_root = tree.terminal[:, 0]
        can_expand = (existing_child < 0) & (new_idx < n_nodes) & ~reuse_root & active
        node_for_stats = torch.where(
            existing_child >= 0, existing_child, new_idx.clamp(max=n_nodes - 1)
        )
        node_for_stats = torch.where(reuse_root, 0, node_for_stats)
        # masked lanes write the scratch row
        exp_idx = torch.where(can_expand, node_for_stats, n_nodes)

        tree.prior[b_idx, exp_idx] = evals.priors
        tree.child[b_idx, leaf_parent, leaf_action] = torch.where(
            can_expand, node_for_stats, existing_child
        )
        tree.parent[b_idx, exp_idx] = leaf_parent
        tree.stats[b_idx, exp_idx, 7] = black_wl
        tree.terminal[b_idx, exp_idx] = term
        if sb is not None:
            tree.black_sb[b_idx, exp_idx] = sb
        for name, buf in tree.states.fields().items():
            buf[b_idx, exp_idx] = getattr(child_states, name)
        tree.next_free = tree.next_free + can_expand.to(torch.int64)

        # ---- backup along path + the leaf: one gather + one scatter ----
        leaf_ok = (can_expand | (existing_child >= 0)) & ~reuse_root & active
        upd_idx = torch.cat(
            [
                path,
                torch.where(leaf_ok, node_for_stats, -1)[:, None],
                torch.where(reuse_root & active, 0, -1)[:, None],
            ],
            1,
        )                                                 # [B, D+2]
        ok = (upd_idx >= 0) & active[:, None]
        idx_safe = upd_idx.clamp(min=0)
        bb = b_idx[:, None].expand_as(idx_safe)

        old = tree.stats[bb, idx_safe]                    # [B, D+2, 8]
        old_v = old[..., 0]
        old_wl = old[..., 1]
        old_sc = old[..., 3]

        def wdelta(x, old_acc, ov):
            old_delta = torch.where(ov > 0, x - old_acc / ov.clamp(min=1.0), 0.0)
            new_delta = x - (old_acc + x) / (ov + 1.0)
            return old_delta * new_delta

        wl_e = black_wl[:, None]
        dr_e = draw[:, None]
        sc_e = black_score[:, None]
        vf = ok.to(torch.float32)

        nv2 = old_v + 1.0
        acc_sc2 = old_sc + sc_e
        sqs2 = old[..., 5] + wdelta(sc_e, old_sc, old_v)
        mean2 = acc_sc2 / nv2
        if sb is not None:
            mean2 = mean2 + tree.black_sb[bb, idx_safe]
        var2 = torch.where(nv2 > 1.0, sqs2 / (nv2 - 1.0).clamp(min=1.0), 1.0)
        se_new = expected_score_value(
            mean2, torch.sqrt(var2.clamp(min=0.0)),
            tree.score_center[:, None].expand_as(mean2),
            cfg.score_utility_div, float(self.env.n),
        ) * cfg.score_utility_factor

        delta = torch.stack(
            [
                vf,
                wl_e * vf,
                dr_e * vf,
                sc_e * vf,
                wdelta(wl_e, old_wl, old_v) * vf,
                wdelta(sc_e, old_sc, old_v) * vf,
                (se_new - old[..., 6]) * vf,
                torch.zeros_like(vf),
            ],
            -1,
        )
        idx_scatter = torch.where(ok, idx_safe, n_nodes)
        tree.stats.index_put_((bb, idx_scatter), delta, accumulate=True)

        # root ownership running average
        rv = tree.stats[:, 0, 0]
        tree.root_ownership = torch.where(
            active[:, None],
            tree.root_ownership + (black_own - tree.root_ownership) / rv[:, None],
            tree.root_ownership,
        )

    def run(self, tree: Tree, num_sims: int, budget=None, ctx=None) -> Tree:
        """Run `num_sims` lockstep simulations. `budget` ([B] int) caps the
        playouts of each lane: simulation i runs on the lanes with i <
        budget (a device compare, no host sync). The call is one run
        record of the recorder (`telemetry`), which counts B x `num_sims`
        lane-simulations and, as a device scalar, those inside their
        budget on a root that is not terminal."""
        with T.run(num_sims):
            root_term = tree.terminal[:, 0]
            T.count("lane_sims", root_term.shape[0] * num_sims)
            if budget is None:
                T.count("lane_sims_active", (~root_term).sum() * num_sims)
            else:
                T.count("lane_sims_active",
                        torch.where(root_term, 0, budget.clamp(0, num_sims)).sum())
            for i in range(num_sims):
                active = None if budget is None else i < budget
                tree = self.simulate(tree, i, active, ctx)
        return tree

    # ------------------------------------------------------------------
    # tree reuse across moves
    # ------------------------------------------------------------------

    @torch.no_grad()
    def advance_root(self, tree: Tree, actions, new_root_states: GoState,
                     gen=None, use_noise=None, use_gumbel=None, prior_mask=None,
                     ctx=None):
        """Re-root each tree at the chosen move's child and compact the
        kept subtree to the front of the node arrays; lanes whose child was
        never expanded (or whose root was terminal) get a fresh tree.
        Membership is pointer doubling over the parent array, the
        compaction a prefix-sum renumbering in old-index order (new root
        first) and one scatter per array, as in the JAX package, so the
        re-rooted tree equals the JAX tree array for array. Returns
        (tree, has_reuse [B] bool)."""
        cfg = self.cfg
        n_nodes = cfg.max_nodes
        b = tree.stats.shape[0]
        dev = tree.stats.device
        b_idx = torch.arange(b, device=dev)
        bb = b_idx[:, None]
        nodes = torch.arange(n_nodes, device=dev)[None, :]
        actions = actions.to(torch.int64)

        new_root = tree.child[b_idx, 0, actions]              # -1 = none
        has_reuse = (new_root >= 0) & ~tree.terminal[:, 0]
        root_safe = new_root.clamp(min=0)[:, None]

        # membership via pointer doubling over parents (roots self-loop)
        parent = tree.parent[:, :n_nodes]
        in_sub = nodes == root_safe
        anc = torch.where(parent >= 0, parent, nodes)
        steps = max(1, int(np.ceil(np.log2(max(cfg.max_depth, 2))))) + 1
        for _ in range(steps):
            in_sub = in_sub | in_sub.gather(1, anc)
            anc = anc.gather(1, anc)
        in_sub = in_sub & (nodes < tree.next_free[:, None])

        # renumber: new root -> 0, the others by old-index rank; the rest
        # goes to the scratch row
        is_other = in_sub & (nodes != root_safe)
        rank = torch.cumsum(is_other.to(torch.int64), 1)
        new_id = torch.where(nodes == root_safe, 0, rank)
        new_id = torch.where(in_sub, new_id, n_nodes)
        count = 1 + rank[:, -1]
        lookup = torch.cat([new_id, torch.full((b, 1), n_nodes, device=dev,
                                                dtype=torch.int64)], 1)

        def remap(c):
            """old child/parent index -> new index (-1 preserved)."""
            mapped = lookup.gather(1, c.clamp(min=0).reshape(b, -1)).reshape(c.shape)
            return torch.where((c >= 0) & (mapped < n_nodes), mapped, -1)

        def compact(arr, fill=0):
            out = torch.full_like(arr, fill)
            out[bb, new_id] = arr[:, :n_nodes]
            return out

        child = compact(tree.child, -1)
        child[bb, new_id] = remap(tree.child[:, :n_nodes])
        parent = compact(tree.parent, -1)
        parent[bb, new_id] = remap(tree.parent[:, :n_nodes])
        parent[:, 0] = -1
        reused = dataclasses.replace(
            tree,
            prior=compact(tree.prior),
            child=child,
            parent=parent,
            stats=compact(tree.stats),
            terminal=compact(tree.terminal),
            black_sb=compact(tree.black_sb),
            states=tree.states.map(compact),
            next_free=count,
        )

        # a fresh tree for every lane (it also brings the new root evals
        # and noise); the cache rides through it
        fresh = self.init_tree(new_root_states, gen if gen is not None else tree.gen,
                               use_noise=use_noise, use_gumbel=use_gumbel,
                               prior_mask=prior_mask, ctx=ctx, cache=tree.cache)

        # reused lanes: the authoritative root state, the fresh root priors
        # (a reused root was expanded as a leaf), fresh noise and flags
        slim = new_root_states.replace(hash_history=new_root_states.hash_history[:, :1])
        for name, buf in reused.states.fields().items():
            buf[:, 0] = getattr(slim, name)
        reused.prior[:, 0] = fresh.prior[:, 0]
        if prior_mask is not None:
            pri = torch.where(prior_mask, reused.prior[:, 0], 0.0)
            reused.prior[:, 0] = pri / pri.sum(-1, keepdim=True).clamp(min=1e-12)
        for name in ("root_noise", "use_noise", "use_gumbel", "root_ownership"):
            setattr(reused, name, getattr(fresh, name))

        def pick(r, f):
            return torch.where(has_reuse.view((b,) + (1,) * (r.ndim - 1)), r, f)

        merged = {f.name: pick(getattr(reused, f.name), getattr(fresh, f.name))
                  for f in dataclasses.fields(Tree)
                  if f.name not in ("states", "cache", "gen", "root_gumbel")}
        out = Tree(**merged,
                   states=GoState(**{k: pick(v, getattr(fresh.states, k))
                                     for k, v in reused.states.fields().items()}),
                   cache=fresh.cache, gen=fresh.gen, root_gumbel=fresh.root_gumbel)
        # freeze the score-utility center after the merge: reused roots
        # carry the previous search's estimate
        out.score_center = out.stats[:, 0, 3] / out.stats[:, 0, 0].clamp(min=1.0)
        return out, has_reuse

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def root_child_visits(self, tree: Tree) -> torch.Tensor:
        """[B, A] visit counts of root children."""
        g, _ = self._child_stats(tree)
        return g[..., 0].to(torch.int32)

    def root_child_q(self, tree: Tree, color) -> torch.Tensor:
        """[B, A] mean child values in `color` perspective; unvisited 0."""
        g, _ = self._child_stats(tree)
        nv = g[..., 0]
        wl_b = g[..., 1] / nv.clamp(min=1.0)
        wl = torch.where(color[:, None] == 0, wl_b, 1.0 - wl_b)
        return torch.where(nv > 0, wl, 0.0)

    def root_lcb_scores(self, tree: Tree) -> torch.Tensor:
        """[B, A] LCB utility per root child: lcb = mean - z*stddev/visits
        (z = t-quantile at dof visits-2), mixed = lcb + score_eval,
        rlcb = mixed*(1 - lcb_reduction) + lcb_reduction*visits/cv;
        visits <= 1 gives prior - 1e6, unvisited -inf."""
        cfg = self.cfg
        g, _ = self._child_stats(tree)
        nv = g[..., 0]
        visits = nv.to(torch.int32)
        color = tree.states.to_move[:, 0]
        wl_b = g[..., 1] / nv.clamp(min=1.0)
        mean = torch.where(color[:, None] == 0, wl_b, 1.0 - wl_b)
        var = torch.where(visits > 1, g[..., 4] / (nv - 1.0).clamp(min=1.0), 1.0)
        stddev = torch.sqrt(var.clamp(min=0.0))
        z_tab = torch.from_numpy(_make_lcb_z_table(cfg.ci_alpha)).to(nv.device)
        z = z_tab[(visits - 2).clamp(0, z_tab.shape[0] - 1).to(torch.int64)]
        lcb = mean - z * stddev / nv.clamp(min=1.0)
        sign = torch.where(color == 0, 1.0, -1.0)[:, None]
        mixed = lcb + sign * g[..., 6]
        cv = nv.sum(-1, keepdim=True).clamp(min=1.0)
        red = float(np.clip(cfg.lcb_reduction, 0.0, 1.0))
        rlcb = mixed * (1.0 - red) + red * (nv / cv)
        rlcb = torch.where(visits <= 1, tree.prior[:, 0] - 1e6, rlcb)
        return torch.where(visits > 0, rlcb, -torch.inf)

    def best_move(self, tree: Tree, allow_pass=None) -> torch.Tensor:
        """[B] argmax of the LCB utility over visited children; the raw
        prior's argmax when nothing is visited. `allow_pass` ([B] bool):
        where False, pass is kept only if it is the sole visited move (the
        self-play forbid-pass rule)."""
        visits = self.root_child_visits(tree)
        score = self.root_lcb_scores(tree)
        if allow_pass is not None:
            pass_a = tree.num_actions - 1
            has_other = (visits[:, :pass_a] > 0).any(-1)
            kill = ~allow_pass & has_other
            score = score.clone()
            visits = visits.clone()
            score[:, pass_a] = torch.where(kill, -torch.inf, score[:, pass_a])
            visits[:, pass_a] = torch.where(kill, 0, visits[:, pass_a])
        any_visited = (visits > 0).any(-1)
        best_lcb = score.argmax(-1)
        best_prior = tree.prior[:, 0].argmax(-1)
        return torch.where(any_visited, best_lcb, best_prior)


def sample_gumbel(shape, gen):
    """Standard Gumbel noise from `gen` (on the generator's device)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp(min=1e-20)))


_GAMMA_ROUNDS = 16


def sample_gamma(alpha, gen):
    """Gamma(alpha, 1) samples from `gen` (torch's own gamma sampler takes
    no generator): Marsaglia-Tsang with a fixed number of rounds (each
    accepts with probability >= 0.95 for shape >= 1, so no lane is left
    after 16 rounds but with probability < 1e-20; such a lane keeps the
    mode), no host sync; shape < 1 through the boost G(a) = G(a + 1) *
    U^(1/a)."""
    a1 = torch.where(alpha < 1.0, alpha + 1.0, alpha)
    d = a1 - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = d.clone()
    done = torch.zeros_like(alpha, dtype=torch.bool)
    for _ in range(_GAMMA_ROUNDS):
        x = torch.randn(alpha.shape, generator=gen, device=gen.device)
        u = torch.rand(alpha.shape, generator=gen, device=gen.device)
        v = (1.0 + c * x) ** 3
        vs = v.clamp(min=1e-30)
        ok = (v > 0) & (torch.log(u.clamp(min=1e-30))
                        < 0.5 * x * x + d - d * vs + d * torch.log(vs))
        out = torch.where(ok & ~done, d * vs, out)
        done = done | ok
    u = torch.rand(alpha.shape, generator=gen, device=gen.device)
    boost = torch.where(alpha < 1.0, u.clamp(min=1e-30) ** (1.0 / alpha), 1.0)
    return out * boost
