"""Gumbel / Sequential-Halving root selection and completed-Q targets
(PyTorch port of sayuri_tpu.mcts.gumbel).

- The Sequential-Halving walk over the visit-sorted root children does not
  depend on the data given the config, so it is precomputed as a static
  (slot, occurrence) sequence (``sh_sequence``) and the root selection is
  one gather + argmax: the first slot whose quota the existing visits do
  not cover yet picks the target visit count, and among the children with
  that count the winner maximizes gumbel + log(prior) + sigma(completed
  Q), sigma(q) = (c_visit + min(threshold, max_visits)) * c_scale * q,
  completed Q = WL + score utility.
- ``completed_q_policy`` is the improved policy target: softmax of
  log(prior) + sigma(completed Q), unvisited children filled with the
  approximate Q, small probabilities pruned.
- ``gumbel_move`` picks the move after a Gumbel search among the
  max-visit children.

Fresh Gumbel noise is drawn at every root selection and at the final move
pick, from the tree's torch.Generator (the JAX package folds its key by
simulation index). With SearchConfig.gumbel_per_selection=False one draw a
search, made when the tree is built (``Tree.root_gumbel``), serves every
selection and the move pick: the original Gumbel-AlphaZero formulation,
which ``tools/ab_match.py`` plays against the default.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sayuri_tpu_torch.mcts.core import sample_gumbel


def _selection_gumbel(mcts, tree, sim_idx):
    """[B, A] Gumbel noise for this selection: fresh from the tree's
    generator when cfg.gumbel_per_selection (`sim_idx` None tags the final
    move pick), else the search's one draw."""
    if not mcts.cfg.gumbel_per_selection:
        return tree.root_gumbel
    return sample_gumbel(tree.prior[:, 0].shape, tree.gen)


@functools.lru_cache(maxsize=None)
def sh_sequence(considered_moves: int, prom_visits: int, threshold: int):
    """Static SH walk: (slot_rank[t], occurrence_count[t]) for t <
    threshold, numpy int32."""
    n = int(math.log2(max(1, considered_moves))) + 1
    width0 = 2 ** (n - 1)
    seq = []
    width, level = width0, max(1, prom_visits)
    while len(seq) < threshold:
        for _ in range(level):
            for j in range(width):
                seq.append(j)
                if len(seq) >= threshold:
                    break
            if len(seq) >= threshold:
                break
        if len(seq) >= threshold:
            break
        if width == 1:
            width, level = width0, max(1, prom_visits)
        else:
            width //= 2
            level *= 2
    seq = np.asarray(seq[:threshold], np.int32)
    occ = np.zeros_like(seq)
    counts = {}
    for t, j in enumerate(seq):
        counts[j] = counts.get(j, 0) + 1
        occ[t] = counts[j]
    return seq, occ


@functools.lru_cache(maxsize=None)
def _sh_tensors(considered_moves, prom_visits, threshold, device):
    seq, occ = sh_sequence(considered_moves, prom_visits, threshold)
    return (torch.from_numpy(seq.astype(np.int64)).to(device),
            torch.from_numpy(occ.astype(np.int64)).to(device))


def _child_gumbel_eval(mcts, tree, color):
    """([B, A] WL(color) + score utility of each root child, 0 where
    unvisited; [B, A] int32 child visits)."""
    g, _ = mcts._child_stats(tree)
    nv = g[..., 0]
    wl_b = g[..., 1] / nv.clamp(min=1.0)
    black = color[:, None] == 0
    wl = torch.where(black, wl_b, 1.0 - wl_b)
    se = torch.where(black, 1.0, -1.0) * g[..., 6]
    return torch.where(nv > 0, wl + se, 0.0), nv.to(torch.int32)


def _sigma(mcts, q, max_visits):
    cfg = mcts.cfg
    return ((cfg.gumbel_c_visit + max_visits.clamp(max=cfg.gumbel_playouts_threshold))
            * cfg.gumbel_c_scale * q)


def root_scores(mcts, tree, sim_idx=None):
    """[B, A] Gumbel-SH selection scores at the root, -inf outside the
    candidate set; lanes whose SH budget is exhausted get all -inf (the
    caller falls back to PUCT)."""
    cfg = mcts.cfg
    A = tree.num_actions
    prior = tree.prior[:, 0]
    legal = prior > 0
    color = tree.states.to_move[:, 0]

    q, nv = _child_gumbel_eval(mcts, tree, color)
    visits = torch.where(legal, nv, -1)
    sorted_v = torch.sort(visits, dim=-1, descending=True).values
    max_visits = sorted_v[:, 0].clamp(min=0)

    seq, occ = _sh_tensors(min(cfg.gumbel_considered_moves, A), cfg.gumbel_prom_visits,
                           cfg.gumbel_playouts_threshold, str(prior.device))
    c_at_seq = sorted_v[:, seq]                        # [B, threshold]
    cond = (occ[None, :] > c_at_seq) & (c_at_seq >= 0)
    active = cond.any(-1)
    t_star = cond.to(torch.int8).argmax(-1)
    target = c_at_seq.gather(1, t_star[:, None])       # [B, 1]

    sig = torch.where(nv > 0, _sigma(mcts, q, max_visits[:, None]), 0.0)
    gumbel = _selection_gumbel(mcts, tree, sim_idx)
    logits = gumbel + torch.log(prior.clamp(min=1e-25)) + sig
    cand = legal & (visits == target) & active[:, None]
    return torch.where(cand, logits, -torch.inf)


def completed_q_policy(mcts, tree):
    """[B, A] improved policy target by completed-Q mixing."""
    A = tree.num_actions
    prior = tree.prior[:, 0]
    legal = prior > 0
    color = tree.states.to_move[:, 0]

    q, nv = _child_gumbel_eval(mcts, tree, color)
    cv = nv.sum(-1).to(torch.float32)
    max_visits = nv.amax(-1)
    visited = nv > 0
    weighted_q = torch.where(visited, prior * q, 0.0).sum(-1)
    weighted_pi = torch.where(visited, prior, 0.0).sum(-1)

    net_wl = tree.stats[:, 0, 7]
    raw = torch.where(color == 0, net_wl, 1.0 - net_wl)
    approx_q = (
        raw + torch.where(weighted_pi > 0, cv / weighted_pi, 0.0) * weighted_q
    ) / (1.0 + cv)

    completed = torch.where(visited, q, approx_q[:, None])
    logits = torch.log(prior.clamp(min=1e-25)) + _sigma(mcts, completed,
                                                       max_visits[:, None])
    p = _softmax(torch.where(legal, logits, -torch.inf))
    # prune negligible probabilities
    p = torch.where(p >= 1.0 / (100.0 + A), p, 0.0)
    return p / p.sum(-1, keepdim=True).clamp(min=1e-12)


def gumbel_move(mcts, tree, allow_pass):
    """[B] best move after a Gumbel search: among the max-visit children,
    argmax of gumbel + log(prior) + sigma(Q); pass only where `allow_pass`
    ([B] bool) or no other child was visited."""
    pass_a = tree.num_actions - 1
    prior = tree.prior[:, 0]
    legal = prior > 0
    color = tree.states.to_move[:, 0]

    q, nv = _child_gumbel_eval(mcts, tree, color)
    max_visits = torch.where(legal, nv, 0).amax(-1)
    sig = torch.where(nv > 0, _sigma(mcts, q, max_visits[:, None]), 0.0)
    gumbel = _selection_gumbel(mcts, tree, None)
    logits = gumbel + torch.log(prior.clamp(min=1e-25)) + sig

    cand = legal & (nv == max_visits[:, None]) & (max_visits[:, None] > 0)
    scores = torch.where(cand, logits, -torch.inf)

    num_candidates = ((nv > 0) & legal).sum(-1)
    allow = allow_pass | (num_candidates <= 1)
    no_pass = scores.clone()
    no_pass[:, pass_a] = -torch.inf
    use_np = ~allow & torch.isfinite(no_pass).any(-1)
    return torch.where(use_np, no_pass.argmax(-1), scores.argmax(-1))


def _softmax(logits):
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(logits - m)
    return e / e.sum(-1, keepdim=True).clamp(min=1e-12)
