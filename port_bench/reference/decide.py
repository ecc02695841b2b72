"""The reference's judgement of what the search decided.

- `completed_q_target`: the improved policy a kept (full, Gumbel) search
  records as its training target, worked out again from the root's stats:
  softmax over the legal moves of log(prior) + sigma(completed Q), the
  unvisited children's Q filled in by the prior-weighted mean of the
  visited ones and the net's value, small probabilities pruned; a kept
  target further than TARGET_TOL from it (total variation) is a fault.
- `move_faults`: played moves that the root's stats do not allow under
  the search's rule: a Gumbel search plays one of its most visited
  children; a fast (PUCT) search plays the child of the highest
  lower-confidence-bound utility, with pass or without it.
- `puct_faults`: a PUCT search replayed simulation by simulation from the
  evaluations stored in its tree; each selection has to pick a child that
  the program's final tree gives a visit still to come.

The constants are the reference engine's defaults, which the configured
searches keep. Every computation is float64; `TOL` covers the float32
rounding of the program's sums.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

# Gumbel: sigma(q) = (C_VISIT + min(max visits, THRESHOLD)) * C_SCALE * q
C_VISIT, C_SCALE, THRESHOLD = 50.0, 1.0, 400
# PUCT
CPUCT_INIT, CPUCT_BASE, CPUCT_BASE_FACTOR = 0.5, 19652.0, 1.0
K_FACTOR, K_BASE = 4.0, 10000.0
FPU_REDUCTION = ROOT_FPU_REDUCTION = 0.25
SCORE_UTILITY_FACTOR, SCORE_UTILITY_DIV = 0.4, 1.0
# LCB move choice
LCB_REDUCTION, CI_ALPHA = 0.02, 1e-5
TOL = 1e-4
# float32 rounding moves a target by under 2e-6 (total variation)
TARGET_TOL = 1e-3

_GH_X, _GH_W = np.polynomial.hermite_e.hermegauss(11)
_GH_W = _GH_W / _GH_W.sum()


def _child_q(g, color):
    """(mean winrate of each root child for the side to move, 0 where
    unvisited; visits) from the children's stats g [K, A, 8]."""
    nv = g[..., 0]
    wl_b = g[..., 1] / nv.clamp(min=1.0)
    black = (color == 0)[:, None]
    return torch.where(nv > 0, torch.where(black, wl_b, 1.0 - wl_b), 0.0), nv


def completed_q_target(prior, g, net_wl, color):
    """[K, A] target policy of a Gumbel search: `prior` [K, A] the root's
    priors (0 off the legal moves), `g` [K, A, 8] its children's stats
    (visits, black's winrate sum, ..., score utility at 6), `net_wl` [K]
    the net's black winrate at the root, `color` [K] the side to move."""
    prior, g, net_wl = prior.double(), g.double(), net_wl.double()
    a = prior.shape[-1]
    wl, nv = _child_q(g, color)
    sign = torch.where(color == 0, 1.0, -1.0).double()[:, None]
    q = torch.where(nv > 0, wl + sign * g[..., 6], 0.0)
    visited = nv > 0
    cv = nv.sum(-1)
    weighted_q = torch.where(visited, prior * q, 0.0).sum(-1)
    weighted_pi = torch.where(visited, prior, 0.0).sum(-1)
    raw = torch.where(color == 0, net_wl, 1.0 - net_wl)
    approx = (raw + torch.where(weighted_pi > 0, cv / weighted_pi.clamp(min=1e-300), 0.0)
              * weighted_q) / (1.0 + cv)
    completed = torch.where(visited, q, approx[:, None])
    sigma = (C_VISIT + nv.amax(-1, keepdim=True).clamp(max=THRESHOLD)) * C_SCALE * completed
    logits = torch.log(prior.clamp(min=1e-25)) + sigma
    p = torch.softmax(torch.where(prior > 0, logits, -torch.inf), -1)
    p = torch.where(p >= 1.0 / (100.0 + a), p, 0.0)
    return p / p.sum(-1, keepdim=True).clamp(min=1e-12)


def _t_quantiles(size=1000):
    """Student-t quantiles of the complement CI_ALPHA at dof 0..size-1 (the
    reference engine's approximation from the normal quantile)."""
    z = statistics.NormalDist().inv_cdf(1.0 - CI_ALPHA)
    dof = np.arange(size, dtype=np.float64)
    n_hi = np.maximum(dof + 1.0, 2.0)
    n_lo = dof + 2.0
    hi = np.sqrt(n_hi * np.exp(z * z * (n_hi - 1.5) / ((n_hi - 1.0) ** 2)) - n_hi)
    lo = np.sqrt(n_lo * np.exp(z * z * (n_lo - 0.853999327911)
                               / ((n_lo - 1.044042304114) * (n_lo - 0.954115472059))) - n_lo)
    return torch.from_numpy(np.where(dof > 8, hi, lo))


def lcb_utility(prior, g, color):
    """[K, A] the LCB utility of each root child: the winrate's lower
    bound plus the score utility, mixed with the visit share; children of
    one visit score prior - 1e6 in float32, as the search computes it,
    which rounds to steps of 1/16, so that they tie below every other;
    unvisited -inf."""
    prior, g = prior.double(), g.double()
    wl, nv = _child_q(g, color)
    var = torch.where(nv > 1, g[..., 4] / (nv - 1.0).clamp(min=1.0), 1.0)
    z = _t_quantiles().to(nv.device)[(nv - 2).clamp(0, 999).long()]
    lcb = wl - z * var.clamp(min=0.0).sqrt() / nv.clamp(min=1.0)
    sign = torch.where(color == 0, 1.0, -1.0).double()[:, None]
    mixed = lcb + sign * g[..., 6]
    cv = nv.sum(-1, keepdim=True).clamp(min=1.0)
    rlcb = mixed * (1.0 - LCB_REDUCTION) + LCB_REDUCTION * nv / cv
    rlcb = torch.where(nv <= 1, (prior.float() - 1e6).double(), rlcb)
    return torch.where(nv > 0, rlcb, -torch.inf)


def move_faults(prior, g, color, gumbel, move):
    """Count of the [K] played moves that the root's stats do not allow:
    with `gumbel`, a legal child of the most visits; else the child of the
    highest LCB utility (within TOL) with or without pass, or the highest
    prior where nothing was visited."""
    nv = g[..., 0].double()
    legal = prior > 0
    most = torch.where(legal, nv, -1.0).amax(-1)
    mv = move[:, None]
    g_ok = legal.gather(1, mv)[:, 0] & (nv.gather(1, mv)[:, 0] == most)
    util = lcb_utility(prior, g, color)
    at = util.gather(1, mv)[:, 0]
    no_pass = util.clone()
    no_pass[:, -1] = -torch.inf
    lcb_ok = torch.isfinite(at) & ((at >= util.amax(-1) - TOL) | (at >= no_pass.amax(-1) - TOL))
    none = (nv == 0).all(-1)
    prior_ok = prior.gather(1, mv)[:, 0] >= prior.amax(-1)
    p_ok = torch.where(none, prior_ok, lcb_ok)
    ok = torch.where(gumbel, g_ok | (most <= 0), p_ok)
    return int((~ok).sum())


def _score_utility(mean, std, center, n):
    x = mean + std * _GH_X
    sv = np.arctan((x - center) / (SCORE_UTILITY_DIV * n)) * (2.0 / np.pi)
    return float((sv * _GH_W).sum()) * SCORE_UTILITY_FACTOR


def puct_faults(tree, lane, color0, playouts, max_depth, n=19):
    """Selections of one lane's PUCT search that break its rule. The search
    is replayed from the root: each node's own evaluation (black's
    winrate, and its score: its sum less its children's) is read from the
    program's tree, and every simulation descends by the PUCT scores of
    the replay's own stats, expands the leaf the program expanded there
    and backs its evaluation up. A selection whose best child (within TOL)
    has no visit to come in the program's final tree counts, and the
    replay goes on to the best child that has; so do final visit counts
    that differ."""
    prior = tree["prior"][lane].double().numpy()
    child = tree["child"][lane].numpy()
    stats = tree["stats"][lane].double().numpy()
    term = tree["terminal"][lane].numpy()
    nodes = int(tree["next_free"][lane])
    if term[0]:
        return 0
    final_v = stats[:nodes, 0]
    kids = [child[i][child[i] >= 0] for i in range(nodes)]
    own_v = np.array([final_v[i] - final_v[k].sum() for i, k in enumerate(kids)])
    own_wl = stats[:nodes, 7]
    own_sc = np.array([stats[i, 3] - stats[k, 3].sum() for i, k in enumerate(kids)])
    own_sc = own_sc / np.maximum(own_v, 1.0)
    center = own_sc[0]
    v, w, s, sq_w, sq_s, se = (np.zeros(nodes) for _ in range(6))
    replay_child = np.full(child[:nodes].shape, -1)
    faults = 0
    # the root as the search starts: its own evaluation, one visit
    v[0], w[0], s[0] = 1.0, own_wl[0], own_sc[0]
    se[0] = _score_utility(center, 1.0, center, n)

    def backup(path, x_wl, x_sc):
        for i in path:
            ov = v[i]
            dw = (x_wl - w[i] / ov if ov > 0 else 0.0) * (x_wl - (w[i] + x_wl) / (ov + 1.0))
            ds = (x_sc - s[i] / ov if ov > 0 else 0.0) * (x_sc - (s[i] + x_sc) / (ov + 1.0))
            v[i] += 1.0
            w[i] += x_wl
            s[i] += x_sc
            sq_w[i] += dw
            sq_s[i] += ds
            var = sq_s[i] / (v[i] - 1.0) if v[i] > 1.0 else 1.0
            se[i] = _score_utility(s[i] / v[i], math.sqrt(max(var, 0.0)), center, n)

    def select(i, depth):
        p = prior[i]
        ch = replay_child[i]
        has = ch >= 0
        c = np.where(has, ch, 0)
        nv = np.where(has, v[c], 0.0)
        black = (color0 ^ (depth & 1)) == 0
        wl_child = np.where(has, w[c], 0.0) / np.maximum(nv, 1.0)
        wl_child = wl_child if black else 1.0 - wl_child
        se_c = np.where(has, se[c], 0.0) * (1.0 if black else -1.0)
        var = np.where(nv > 1, np.where(has, sq_w[c], 0.0) / np.maximum(nv - 1.0, 1.0), 1.0)
        k_raw = np.clip(K_FACTOR * np.sqrt(np.maximum(var, 0.0)) / np.maximum(nv, 1.0), 0.5, 1.4)
        cv = nv.sum()
        tvp = p[nv > 0].sum()
        net_wl = own_wl[i] if black else 1.0 - own_wl[i]
        node_wl = w[i] / max(v[i], 1.0)
        node_wl = node_wl if black else 1.0 - node_wl
        red = (ROOT_FPU_REDUCTION if depth == 0 else FPU_REDUCTION) * math.sqrt(tvp)
        fpu = (1.0 - tvp * tvp) * net_wl + tvp * tvp * node_wl - red
        q = np.where(nv > 0, wl_child + se_c, fpu)
        cpuct = CPUCT_INIT + CPUCT_BASE_FACTOR * math.log((cv + CPUCT_BASE + 1.0) / CPUCT_BASE)
        alpha = 1.0 / (1.0 + math.sqrt(cv / K_BASE))
        k = np.where(nv > 1, alpha * k_raw + (1.0 - alpha), 1.0)
        score = np.where(p > 0, q + cpuct * k * p * math.sqrt(cv) / (1.0 + nv), -np.inf)
        # a child may still be chosen while the replay's visits are below
        # the program's final ones
        prog = child[i]
        left = (prog >= 0) & (np.where(prog >= 0, final_v[np.maximum(prog, 0)], 0.0)
                              > np.where(has, v[c], 0.0))
        best = score.max()
        exact = np.flatnonzero(score >= best)
        pick = exact[np.argmax(p[exact])]
        if left[pick]:
            return int(pick), False
        near = np.flatnonzero((score >= best - TOL) & left)
        if len(near):
            return int(near[np.argmax(score[near])]), False
        rest = np.flatnonzero(left & (p > 0))
        return (int(rest[np.argmax(score[rest])]) if len(rest) else -1), True

    for _ in range(playouts):
        path, cur, depth = [0], 0, 0
        while True:
            a, bad = select(cur, depth)
            faults += bad
            if a < 0:
                break
            nxt = replay_child[cur, a]
            if nxt < 0:
                nxt = child[cur, a]
                replay_child[cur, a] = nxt
                backup(path + [nxt], own_wl[nxt], own_sc[nxt])
                break
            depth += 1
            if term[nxt] or depth >= max_depth:
                backup(path + [nxt], own_wl[nxt], own_sc[nxt])
                break
            path.append(nxt)
            cur = nxt
    return faults + int((np.abs(v - final_v) > 0.5).sum())
