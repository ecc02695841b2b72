"""Driver of the search cells: whole searches of B midgame roots x P
playouts through `MCTS.init_tree` and `MCTS.run`, the roots' ladder planes
first, a new root set each search (the sets cycle when a window holds
more searches than the workload prepares).

The traffic (workload file): `batch`, `playouts`, `root_sets`,
`max_moves` of the midgame roots, `max_nodes_extra` and `max_depth` of the
trees, `check_lanes` the reference judges."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import program, roots, weights
from port_bench.reference import check as RC
from port_bench.reference import decide as RD
from port_bench.reference import frozen as R


class Search:
    def __init__(self, h):
        from sayuri_tpu_torch.game.state import GoEnv
        from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
        from sayuri_tpu_torch.models.evaluator import make_eval_fn

        wl, dev = h.wl, h.device
        self.h = h
        self.b, self.p = wl["batch"], wl["playouts"]
        self.env = GoEnv(n=19)
        self.weights = weights.make(h.cfg["net"], h.seed, dev)
        model = program.net(h.cfg["net"], self.weights, dev)
        dtype = torch.bfloat16 if h.cfg["serve_dtype"] == "bfloat16" else torch.float32
        eval_fn = make_eval_fn(self.env, model, symmetry="random", ladder_mode="root",
                               compute_dtype=dtype)
        self.mcts = MCTS(self.env, eval_fn, SearchConfig(
            max_nodes=self.p + wl["max_nodes_extra"], max_depth=wl["max_depth"],
            nn_cache_size=0))
        n_sets = wl["root_sets"]
        moves, counts = roots.midgame(self.b * (n_sets + 1), h.seed, dev, wl["max_moves"])
        self.moves = moves.view(n_sets + 1, self.b, -1)
        self.counts = counts.view(n_sets + 1, self.b)
        rule = torch.zeros_like(counts)
        states = program.roots(self.env, moves, counts, rule, 7.5, dev)
        self.sets = [states.map(lambda x, i=i: x[i * self.b:(i + 1) * self.b])
                     for i in range(n_sets + 1)]
        self.n_sets, self.i, self.last = n_sets, 0, None
        self.tree = self._search(self.sets[n_sets])      # warm-up on a set of its own

    def _search(self, states):
        from sayuri_tpu_torch.game.ladder import ladder_planes_batch

        with record_function("bench.ladders"):
            ctx = {"ladders": ladder_planes_batch(states.stones, states.size, states.ko)}
        with record_function("bench.init_tree"):
            tree = self.mcts.init_tree(states, ctx=ctx)
        return self.mcts.run(tree, self.p, ctx=ctx)

    def unit(self):
        self.last = self.i % self.n_sets
        self.i += 1
        self.tree = self._search(self.sets[self.last])
        return {"searches": 1, "sims": self.p, "playouts": self.b * self.p,
                "evals": self.b * (self.p + 1)}

    def collect(self):
        """What the reference judges, taken from the last search of the
        lanes drawn from the seed; the program's state is freed."""
        rng = np.random.default_rng(self.h.seed % (1 << 63))
        lanes = np.sort(rng.choice(self.b, self.h.wl["check_lanes"], replace=False))
        li = torch.as_tensor(lanes, device=self.h.device)
        data = {"trees": program.tree_lanes(self.tree, lanes),
                "moves": self.moves[self.last][li], "counts": self.counts[self.last][li],
                "root_visits": self.tree.stats[:, 0, 0].cpu()}
        self.tree = self.mcts = self.sets = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return data

    def judge(self, data, control=None):
        """The reference's readings of the last search: its boards, nodes and
        backups (reference/check.py) and each sampled lane's PUCT replay
        (reference/decide.py); with `control`, its evaluation in that
        precision stands in for the program's."""
        h, dev = self.h, self.h.device
        trees = data["trees"]
        start, _, illegal = RC.replay(data["moves"], data["counts"], 0, 7.5, dev)
        ladders = R.ladder_planes_batch(start.stones.cpu(), torch.full(
            (start.stones.shape[0],), 19, dtype=torch.int32), start.ko.cpu().to(torch.int32)).to(dev)
        res = RC.judge_trees(h.cfg["net"], self.weights, start, ladders, trees, quant=control)
        # every lane of the batch ran every playout
        root_faults = int((data["root_visits"] != self.p + 1).sum())
        # each lane's search replayed by PUCT from its stored evaluations
        color = start.to_move.cpu().tolist()
        puct = sum(RD.puct_faults(trees, k, color[k], self.p, h.wl["max_depth"])
                   for k in range(len(color)))
        return {"board_mismatches": res["board_mismatches"] + illegal,
                "tree_faults": res["tree_faults"] + root_faults, "puct_faults": puct,
                "prior_tv_max": float(res["prior_tv"].max()),
                "value_gap_max": float(res["value_gap"].max())}

    def check(self, control=None):
        return self.judge(self.collect(), control)


def setup(h):
    return Search(h)
