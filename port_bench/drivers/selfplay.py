"""Driver of the self-play cells: `SelfplayActor.move_step` on B games
from midgame roots, carrying the tree, the move and the resign flags from
move to move as `play_games` does; one timed unit is one move of every
game.

The traffic (workload file): `batch`, `max_moves` of the midgame roots,
`territory_share` of the lanes under the territory rule (the rest area),
`komi`, `config` (the program's self-play config file, whose search and
playout-cap settings the actor takes), `check_lanes` the reference
judges."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import program, roots, weights
from port_bench.reference import check as RC
from port_bench.reference import decide as RD
from port_bench.reference import frozen as R
from port_bench.reference import rules as RU


class Selfplay:
    def __init__(self, h):
        from sayuri_tpu_torch.config import Options
        from sayuri_tpu_torch.game.state import GoEnv
        from sayuri_tpu_torch.mcts.core import MCTS
        from sayuri_tpu_torch.models.evaluator import make_eval_fn
        from sayuri_tpu_torch.selfplay.actor import SelfplayActor

        wl, dev = h.wl, h.device
        self.h = h
        self.b = wl["batch"]
        opts = Options().parse_args(["--config", str(Path(h.root) / wl["config"])])
        self.env = GoEnv(n=19)
        self.weights = weights.make(h.cfg["net"], h.seed, dev)
        model = program.net(h.cfg["net"], self.weights, dev)
        dtype = torch.bfloat16 if h.cfg["serve_dtype"] == "bfloat16" else torch.float32
        eval_fn = make_eval_fn(self.env, model, symmetry="random", ladder_mode="root",
                               compute_dtype=dtype)
        self.actor = SelfplayActor(self.env, MCTS(self.env, eval_fn, opts.search_config()),
                                   opts.selfplay_config())
        self.moves, self.counts = roots.midgame(self.b, h.seed, dev, wl["max_moves"])
        g = torch.Generator(device=dev).manual_seed(h.seed % (1 << 63))
        self.rule = (torch.rand((self.b,), generator=g, device=dev)
                     < wl["territory_share"]).to(torch.int64)
        self.komi = wl["komi"]
        self.states = program.roots(self.env, self.moves, self.counts, self.rule, self.komi, dev)
        self.gen = g
        self.lost = torch.zeros((self.b,), dtype=torch.bool, device=dev)
        self.tree = self.move = None
        self.records, self.snaps, self.root_stats = [], [], []
        rng = np.random.default_rng(h.seed % (1 << 63))
        self.lanes = torch.as_tensor(np.sort(rng.choice(self.b, wl["check_lanes"], replace=False)),
                                     device=dev)
        self._move()                                   # warm-up: the first move
        self.window_from = 1
        self.base = self._counters()

    def _move(self):
        with record_function("actor.move_step"):
            self.states, rec, self.lost, self.tree, self.move = self.actor.move_step(
                self.states, self.gen, self.lost, self.tree, self.move)
        self.records.append(rec)
        # the sampled lanes' tree shape after each search: which search
        # evaluated each node of the last tree (tree reuse keeps nodes)
        li = self.lanes
        self.snaps.append((self.tree.parent[li].clone(), self.tree.next_free[li].clone(),
                           self.tree.child[li, 0].clone()))
        # the sampled lanes' root after the search: priors, the children's
        # stats, the net's winrate, Gumbel or not (what the move and the
        # target are decided from)
        ch = self.tree.child[li, 0]
        g = self.tree.stats[li[:, None], ch.clamp(min=0)] * (ch >= 0)[..., None]
        self.root_stats.append((self.tree.prior[li, 0].clone(), g, self.tree.stats[li, 0, 7].clone(),
                                self.tree.use_gumbel[li].clone()))

    def unit(self):
        self._move()
        return {"moves": 1}

    def _counters(self):
        """The NN cache's counters summed over the lanes: [queries, hits, dups]."""
        c = self.tree.cache
        return ([0, 0, 0] if c is None else
                torch.stack([c.queries.sum(), c.hits.sum(), c.dups.sum()]).tolist())

    def totals(self):
        """Counts over the window: kept positions and lane-moves, and the
        NN cache's queries, hits and in-batch duplicates."""
        recs = self.records[self.window_from:]
        q, hits, dups = (a - b for a, b in zip(self._counters(), self.base))
        return {"positions": int(sum((r.active & ~r.discard).sum() for r in recs)),
                "lane_moves": int(sum(r.active.sum() for r in recs)),
                "queries": q, "hits": hits, "dups": dups}

    def check(self, control=None):
        """The reference's readings: the games replayed from the harness's
        roots through every move the program played (each board before a
        move, legality under positional superko, the final boards), every
        move and kept target against its root's stats (reference/decide.py),
        the last search's tree (its nodes evaluated with the root ladder
        planes of the search that made them, its root under the superko
        purge), and the kept records' targets as distributions."""
        return self.judge(self.collect(), control)

    def collect(self):
        """What the reference judges, for the lanes drawn from the seed; the
        program's state is freed."""
        li = self.lanes
        recs = self.records
        data = dict(
            trees=program.tree_lanes(self.tree, li.cpu().numpy()),
            played=torch.stack([r.move for r in recs], 1)[li].to(torch.int64),
            active=torch.stack([r.active for r in recs], 1)[li],
            before=[r.states.stones[li].clone() for r in recs],
            final=self.states.stones[li].clone(),
            kept=[(r.active & ~r.discard)[li] for r in recs],
            targets=[r.target_policy[li].float() for r in recs],
            snaps=[tuple(x.cpu() for x in snap) for snap in self.snaps],
            root_stats=self.root_stats,
            # evaluations the NN cache served each sampled lane (hits and
            # in-batch duplicates), since the cache was made
            served=(torch.zeros_like(li) if self.tree.cache is None else
                    self.tree.cache.hits[li] + self.tree.cache.dups[li]),
            root_moves=self.moves[li], root_counts=self.counts[li], rule=self.rule[li],
            # every lane's root visits against its budget at the last move
            root_visits=self.tree.stats[:, 0, 0].cpu(),
            budget=torch.where(recs[-1].discard, self.actor.cfg.fastsearch_playouts,
                               self.actor.cfg.playouts).cpu(),
            live=(recs[-1].active & ~self.tree.terminal[:, 0]).cpu())
        self.actor = self.tree = self.states = self.records = self.snaps = self.root_stats = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return data

    def judge(self, data, control=None):
        """The reference's readings of `collect`'s data; with `control`, its
        evaluation in that precision stands in for the program's."""
        h, dev = self.h, self.h.device
        trees, played, active, before, final, kept, targets, snaps = (data[x] for x in (
            "trees", "played", "active", "before", "final", "kept", "targets", "snaps"))
        root_moves, root_counts, rule = data["root_moves"], data["root_counts"], data["rule"]
        k = played.shape[0]

        s, seen, bad = RC.replay(root_moves, root_counts, rule, self.komi, dev)
        seen = list(seen.unbind(1))
        roots, masks = [], []
        target_tv, move_faults, target_faults = [0.0], 0, 0
        for t in range(played.shape[1]):
            go = active[:, t]
            # the move and the kept target, from the root's stats
            prior, g, net_wl, gumbel = (x.to(dev) for x in data["root_stats"][t])
            move_faults += RD.move_faults(prior[go], g[go], s.to_move[go], gumbel[go],
                                          played[go, t])
            kp = kept[t]
            if bool(kp.any()):
                ref = RD.completed_q_target(prior[kp], g[kp], net_wl[kp], s.to_move[kp])
                tv = 0.5 * (targets[t][kp].double() - ref).abs().sum(-1)
                target_faults += int((tv > RD.TARGET_TOL).sum())
                target_tv.append(float(tv.max()))
            bad += int((go & (s.stones != before[t]).flatten(1).any(-1)).sum())
            mask = RC.superko_mask(s, torch.stack(seen, 1))
            roots.append(s)
            masks.append(mask)
            a = played[:, t]
            s2, legal = RU.play(s, a, keep=go)
            purged = mask.gather(1, a.clamp(max=mask.shape[1] - 1)[:, None])[:, 0]
            bad += int((go & (~legal | purged)).sum())
            s = s2
            seen.append(s.hash())
        bad += int((s.stones != final).flatten(1).any(-1).sum())
        # ladder planes of every search's root: rows 0..k-1 the last root's,
        # then k rows a search
        table = [roots[-1]] + roots
        stacked = RC._stack([(st, j) for st in table for j in range(k)])
        ladders = R.ladder_planes_batch(stacked.stones.cpu(), torch.full(
            (stacked.stones.shape[0],), 19, dtype=torch.int32),
            stacked.ko.cpu().to(torch.int32)).to(dev)
        made = _made_in(snaps, played.cpu())
        last = len(snaps) - 1
        ladder_of = torch.where(made == last, torch.arange(k)[:, None],
                                k + made * k + torch.arange(k)[:, None])
        res = RC.judge_trees(h.cfg["net"], self.weights, roots[-1], ladders, trees,
                             ladder_of=ladder_of, root_mask=masks[-1], quant=control)
        # targets: the completed-Q policy of the root's stats (above),
        # distributions, and at the last root no mass on a purged or
        # illegal move
        faults = target_faults
        for kp, t in zip(kept, targets):
            faults += int((kp & ((t.sum(-1) - 1.0).abs() > 1e-3)).sum())
        ok = torch.cat([RU.legal_board(roots[-1]), torch.ones_like(masks[-1][:, :1])], 1)
        ok = ok & ~masks[-1]
        faults += int((kept[-1] & ((targets[-1] * ~ok).sum(-1) > 1e-6)).sum())
        short = int((data["live"] & (data["root_visits"] < data["budget"] + 1)).sum())
        # the widest gaps over the lanes the NN cache never served: their
        # every node is the net's own evaluation of its position and history
        fresh = (data["served"] == 0).cpu().numpy()[res["lane"]]
        widest = {k: float(res[k][fresh].max()) if fresh.any() else 0.0
                  for k in ("prior_tv", "value_gap")}
        return {"board_mismatches": res["board_mismatches"] + bad,
                "tree_faults": res["tree_faults"] + short, "target_faults": faults,
                "move_faults": move_faults, "target_tv_max": max(target_tv),
                "prior_tv_p90": float(np.quantile(res["prior_tv"], 0.9)),
                "value_gap_p90": float(np.quantile(res["value_gap"], 0.9)),
                "prior_tv_max_uncached": widest["prior_tv"],
                "value_gap_max_uncached": widest["value_gap"],
                "uncached_lanes": int((data["served"] == 0).sum())}


def _made_in(snaps, played):
    """[K, N] the search (0 = the first) whose tree first held each node of
    the last tree. Tree reuse keeps the chosen child's subtree, the child
    as node 0 and the others in their old order, and appends new nodes."""
    parent0, nfree0, _ = snaps[0]
    k, n = parent0.shape
    made = torch.zeros((k, n), dtype=torch.int64)
    for t in range(1, len(snaps)):
        old_parent, old_free, old_child0 = snaps[t - 1]
        _, nfree, _ = snaps[t]
        new = torch.full((k, n), t, dtype=torch.int64)
        for lane in range(k):
            root = int(old_child0[lane, played[lane, t - 1]])
            if root < 0:
                continue
            keep = [root]
            inside = {root}
            for node in range(int(old_free[lane])):
                p, chain = node, []
                while p >= 0 and p not in inside and p != 0:
                    chain.append(p)
                    p = int(old_parent[lane, p])
                if p in inside and node != root:
                    keep.append(node)
                    inside.update(chain)
            keep = [root] + sorted(x for x in keep if x != root)
            count = min(len(keep), int(nfree[lane]))
            new[lane, :count] = made[lane, torch.as_tensor(keep[:count])]
        made = new
    return made


def setup(h):
    return Selfplay(h)
