"""The reference's judgement of what the timed path produced.

`replay` rebuilds games from move lists and counts the moves that were
not legal (suicide, ko, occupied, or positional superko). `judge_trees`
rebuilds every node of the sampled search trees from its root and the
actions along its path, counts the nodes whose board or ko differs from
the program's, re-evaluates every node with the plain net and returns
each node's gap to the program's stored priors (total variation) and
value, and counts the nodes whose backup is off: visits and winrate sums
against the children's and the node's own evaluation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference import frozen as R
from port_bench.reference import rules as RU
from port_bench.reference.evaluate import evaluate


def replay(moves, counts, rule, komi, device, n=19):
    """Play the [K, T] move lists (first `counts` of each row) from empty
    boards. Returns (states [K], hashes [K, T+1, 2] of every position
    reached, illegal move count)."""
    k = moves.shape[0]
    s = RU.empty(k, n, rule, komi, device)
    hashes = [s.hash()]
    illegal = 0
    for t in range(moves.shape[1]):
        go = t < counts
        if not bool(go.any()):
            break
        s2, legal = RU.play(s, moves[:, t].clamp(min=0), keep=go)
        h = s2.hash()
        seen = torch.stack(hashes, 1)
        repeat = (h[:, None] == seen).all(-1).any(-1) & (moves[:, t] < n * n)
        illegal += int((go & (~legal | repeat)).sum())
        s = s2
        hashes.append(torch.where(go[:, None], h, hashes[-1]))
    return s, torch.stack(hashes, 1), illegal


def superko_mask(s: RU.RefState, seen):
    """[K, A] bool: board moves that recreate a position of `seen` [K, L, 2]
    (the positions of each game so far)."""
    k, n = s.stones.shape[0], s.n
    nn = n * n
    acts = torch.arange(nn, device=s.stones.device)
    stones, _, _ = R.play_move(s.stones[:, None].expand(k, nn, n, n).reshape(k * nn, n, n),
                               torch.full((k * nn,), n, dtype=torch.int32, device=acts.device),
                               s.to_move.repeat_interleave(nn), acts.repeat(k))
    h = R.position_hash(stones).view(k, nn, 1, 2)
    hit = (h == seen[:, None]).all(-1).any(-1)
    return torch.cat([hit, torch.zeros_like(hit[:, :1])], 1)


def judge_trees(cfg, w, roots: RU.RefState, ladders, trees, ladder_of=None, root_mask=None,
                quant=None):
    """`trees`: dict of CPU tensors for K lanes (prior [K, N, A], child
    [K, N, A], parent [K, N], stats [K, N, 8], terminal [K, N], stones
    [K, N, n, n], ko [K, N], next_free [K]). `roots`: the reference's root
    states. `ladders` [M, n, n, 4]: root ladder planes of the searches
    that evaluated the nodes; `ladder_of` [K, N] the row of `ladders` a
    node was evaluated with (None: row k for lane k, one search each);
    row k is also the current root's, whose priors are fresh. `root_mask`
    [K, A] bool: the moves the program's root purge removes (None: none).
    With `quant`, the control's evaluation stands in for the program's
    stored outputs. Returns a dict of per-node numpy arrays and counts."""
    dev = roots.stones.device
    k = roots.stones.shape[0]
    nfree = trees["next_free"].tolist()
    lane_of, node_of = [], []
    for lane in range(k):
        lane_of += [lane] * nfree[lane]
        node_of += list(range(nfree[lane]))
    lane_of = np.asarray(lane_of)
    node_of = np.asarray(node_of)
    parent = trees["parent"].numpy()
    child = trees["child"].numpy()
    depth = np.zeros(len(lane_of), np.int64)
    row = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(lane_of, node_of))}
    for i, (lane, node) in enumerate(zip(lane_of, node_of)):
        p = parent[lane, node]
        depth[i] = 0 if node == 0 else depth[row[(lane, int(p))]] + 1
    # node states, level by level from the roots
    order = np.argsort(depth, kind="stable")
    mismatches = illegal = 0
    cur = {}
    for i in order:
        if depth[i] == 0:
            cur[i] = (roots, int(lane_of[i]))
    for d in range(1, int(depth.max()) + 1 if len(depth) else 1):
        level = [i for i in order if depth[i] == d]
        if not level:
            break
        par = [row[(int(lane_of[i]), int(parent[lane_of[i], node_of[i]]))] for i in level]
        acts = []
        for i, p in zip(level, par):
            hit = np.nonzero(child[lane_of[i], node_of[p]] == node_of[i])[0]
            acts.append(int(hit[0]) if len(hit) else 0)
            mismatches += len(hit) != 1
        ps = _stack([cur[p] for p in par])
        nxt, legal = RU.play(ps, torch.tensor(acts, device=dev))
        illegal += int((~legal).sum())
        for j, i in enumerate(level):
            cur[i] = (nxt, j)
    allst = _stack([cur[i] for i in range(len(lane_of))])
    prog_stones = trees["stones"][lane_of, node_of].to(dev)
    prog_ko = trees["ko"][lane_of, node_of].to(dev).to(torch.int64)
    mismatches += int(((allst.stones != prog_stones).flatten(1).any(-1)
                       | (allst.ko != prog_ko)).sum())
    rows = (torch.as_tensor(lane_of) if ladder_of is None
            else ladder_of[lane_of, node_of]).to(dev)
    pri_ref, wl_ref = evaluate(cfg, w, allst, ladders[rows])
    roots_at = np.nonzero(node_of == 0)[0]
    fresh = torch.as_tensor(lane_of[roots_at], device=dev)
    ri = torch.as_tensor(roots_at, device=dev)
    pri_ref[ri] = evaluate(cfg, w, allst.take(ri), ladders[fresh])[0]
    if quant is None:
        pri_prog = trees["prior"][lane_of, node_of].to(dev)
        wl_prog = trees["stats"][lane_of, node_of, 7].to(dev)
    else:
        pri_prog, wl_prog = evaluate(cfg, w, allst, ladders[rows], quant)
        pri_prog[ri] = evaluate(cfg, w, allst.take(ri), ladders[fresh], quant)[0]
    if root_mask is not None:
        at_root = torch.as_tensor(node_of == 0, device=dev)
        m = root_mask[torch.as_tensor(lane_of, device=dev)]
        masked = torch.where(m, 0.0, pri_ref)
        masked = masked / masked.sum(-1, keepdim=True).clamp(min=1e-12)
        pri_ref = torch.where(at_root[:, None], masked, pri_ref)
        if quant is not None:
            masked = torch.where(m, 0.0, pri_prog)
            masked = masked / masked.sum(-1, keepdim=True).clamp(min=1e-12)
            pri_prog = torch.where(at_root[:, None], masked, pri_prog)
    tv = 0.5 * (pri_prog - pri_ref).abs().sum(-1)
    term = trees["terminal"][lane_of, node_of].to(dev)
    vgap = torch.where(term, 0.0, (wl_prog - wl_ref).abs())
    return dict(prior_tv=tv.cpu().numpy(), value_gap=vgap.cpu().numpy(), lane=lane_of,
                board_mismatches=mismatches + illegal, **_backup(trees, lane_of, node_of))


def _stack(pairs):
    """One RefState of the rows (state, index) names."""
    out = {}
    for f in dataclasses.fields(RU.RefState):
        out[f.name] = torch.stack([getattr(s, f.name)[j] for s, j in pairs])
    return RU.RefState(**out)


# float32 sums of at most a tree's nodes' winrates (each in [0, 1]) round
# by less than 2e-5; a backup further off than this is a fault
BACKUP_TOL = 1e-4


def _backup(trees, lane_of, node_of):
    """Tree invariants, counted as faults: a node's visits are 1 + its
    children's (a terminal leaf counts each revisit), and its winrate sum
    is its own evaluation times the visits its children did not take plus
    its children's sums, within BACKUP_TOL a visit."""
    stats = trees["stats"].double().numpy()
    parent = trees["parent"].numpy()
    k, n = parent.shape
    vis = stats[..., 0]
    acc = stats[..., 1]
    cv = np.zeros((k, n))
    ca = np.zeros((k, n))
    has_child = np.zeros((k, n), bool)
    for lane, node in zip(lane_of, node_of):
        p = parent[lane, node]
        if node and p >= 0:
            cv[lane, p] += vis[lane, node]
            ca[lane, p] += acc[lane, node]
            has_child[lane, p] = True
    faults = 0
    for lane, node in zip(lane_of, node_of):
        v = vis[lane, node]
        own = v - cv[lane, node]
        expect = stats[lane, node, 7] * own + ca[lane, node]
        faults += bool(v < 1 or own < 1 or (has_child[lane, node] and own != 1)
                       or abs(acc[lane, node] - expect) > BACKUP_TOL * max(v, 1.0))
    return dict(tree_faults=faults)
