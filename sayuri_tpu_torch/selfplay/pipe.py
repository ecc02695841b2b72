"""Self-play pipe: game generation, data writing and weights refresh
(PyTorch port of sayuri_tpu.selfplay.pipe, one process on one card, or one
process a card over a mesh).

One batched actor plays whole game batches; the filesystem contract is the
reference's: gzip chunks to tdata/<run_id>/ and vdata/<run_id>/ (90/10
split), SGFs to sgf/, query counts to net_queries/, and "reload when new
weights appear" against weights_dir (the newest v5 file by mtime).

With a mesh (``parallel.mesh.Mesh``) each rank plays its own
``parallel_games`` lanes and writes its own files (the run id ends in
``p{rank}`` when the world size is over 1). Rank 0 decides whether to
reload and which file, and broadcasts the decision and then the weights:
the JAX pipe lets each host poll on its own, and a rank that saw a new file
one poll late would skip a broadcast the others wait in. Each rank's
generator is seeded with the seed plus its rank (the JAX package splits
one key over the global lanes instead).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import torch

from sayuri_tpu_torch.game import sgf as SGF
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.game.types import TERRITORY_RULE
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn
from sayuri_tpu_torch.models.network import SayuriNet
from sayuri_tpu_torch.parallel import distributed as DI
from sayuri_tpu_torch.selfplay import data as D
from sayuri_tpu_torch.selfplay.actor import SelfplayActor, SelfplayConfig, assemble_targets
from sayuri_tpu_torch.selfplay.randomize import GameRandomizer, parse_queries


def newest_weights(weights_dir) -> str | None:
    """Newest weight file in the directory (by mtime)."""
    if not weights_dir or not Path(weights_dir).is_dir():
        return None
    files = [p for p in Path(weights_dir).iterdir()
             if p.suffix in (".txt", ".ckpt") or p.name.endswith(".bin.txt")]
    if not files:
        return None
    return str(max(files, key=os.path.getmtime))


class SelfPlayPipe:
    def __init__(
        self,
        out_dir: str,
        boardsize: int = 9,
        komi: float = 7.5,
        parallel_games: int = 32,
        search_cfg: SearchConfig | None = None,
        sp_cfg: SelfplayConfig | None = None,
        weights_dir: str | None = None,
        queries: list[str] | None = None,
        seed: int = 0,
        device="cuda",
        handicap_fair_komi_prob: float = 0.0,
        mesh=None,
    ):
        self.out_dir = Path(out_dir)
        self.sp_cfg = sp_cfg or SelfplayConfig()
        sp = self.sp_cfg
        self.dist = parse_queries(
            queries,
            default_size=boardsize,
            default_komi=komi,
            komi_stddev=sp.komi_stddev,
            komi_big_stddev=sp.komi_big_stddev,
            komi_big_stddev_prob=sp.komi_big_stddev_prob,
            random_moves_factor=max(sp.random_moves_factor, 0.0),
            random_opening_prob=(
                sp.random_opening_prob if sp.random_opening_prob >= 0
                else (0.0 if sp.random_moves_factor <= 0 else 0.75)
            ),
            random_opening_temp=sp.random_opening_temp,
            handicap_fair_komi_prob=handicap_fair_komi_prob,
        )
        # the board buffer covers the largest queried size
        self.env = GoEnv(n=max(boardsize, self.dist.max_boardsize))
        self.komi = komi
        self.parallel_games = parallel_games
        self.weights_dir = weights_dir
        self.search_cfg = search_cfg or SearchConfig(max_nodes=176, gumbel=True)
        self.mesh = mesh
        self.rank, self.world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device).manual_seed(seed * 7919 + self.rank)
        self.run_id = f"{int(time.time()):x}{seed:02x}" + (
            f"p{self.rank}" if self.world > 1 else "")
        self.current_weights = None
        self.games_done = 0
        self.rounds = 0
        self.total_queries = 0
        self.last_round = None
        self._build_actor()
        for sub in ("sgf", "net_queries"):
            (self.out_dir / sub).mkdir(parents=True, exist_ok=True)

    def _build_actor(self):
        path = newest_weights(self.weights_dir)
        if self.mesh is not None:
            path = DI.broadcast_object_from_host0(path)
        self.net = None
        if path:
            net = self._load_net(path).to(self.device).eval()
            if self.mesh is not None:
                DI.broadcast_from_host0(net.state_dict())
            self.net = net
            # random-symmetry leaf evaluation; bf16 on the card
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
            eval_fn = make_eval_fn(self.env, net, symmetry="random", ladder_mode="root",
                                   compute_dtype=dtype)
            self.current_weights = path
        else:
            eval_fn = make_dummy_eval_fn(self.env)
            self.current_weights = None
        mcts = MCTS(self.env, eval_fn, self.search_cfg)
        sp = self.sp_cfg
        if self.current_weights is None:
            # weightless runs: a tenth of the playouts
            sp = type(sp)(**{**sp.__dict__,
                             "playouts": max(1, sp.playouts // 10),
                             "fastsearch_playouts": max(1, sp.fastsearch_playouts // 10)})
        self.actor = SelfplayActor(self.env, mcts, sp)

        # fair komi probes with a quick no-exploring search
        fair_playouts = max(8, self.sp_cfg.fastsearch_playouts or 8)

        def fair_komi_search(states):
            tree = mcts.init_tree(states, torch.Generator(device=self.device).manual_seed(0))
            tree = mcts.run(tree, fair_playouts)
            score_b = tree.stats[:, 0, 3] / tree.stats[:, 0, 0].clamp(min=1.0)
            return torch.where(states.to_move == 0, score_b, -score_b)

        self.randomizer = GameRandomizer(self.env, self.dist, eval_fn,
                                         fair_komi_search=fair_komi_search)

    def _load_net(self, path):
        """The net of a weight file; with a mesh, rank 0 reads the file and
        the other ranks build the same net from its config (the weights
        follow by broadcast)."""
        from sayuri_tpu_torch.models.weights_io import load_checkpoint_for_inference

        if self.mesh is None:
            return load_checkpoint_for_inference(path, boardsize=self.env.n)[1]
        cfg, net = (load_checkpoint_for_inference(path, boardsize=self.env.n)
                    if self.rank == 0 else (None, None))
        cfg = DI.broadcast_object_from_host0(cfg)
        return net if self.rank == 0 else SayuriNet(cfg)

    def should_reload(self) -> bool:
        """New weights appeared (with a mesh: rank 0's answer, on every
        rank)."""
        new = newest_weights(self.weights_dir) != self.current_weights
        if self.mesh is not None:
            new = DI.broadcast_object_from_host0(new)
        return new

    def play_round(self):
        """One batch of games: play, serialize, write chunks and SGFs.
        Returns the number of chunk files written."""
        t0 = time.monotonic()
        states = self.randomizer.prepare(
            self.parallel_games, (self.seed * 1000003 + self.rounds) * self.world + self.rank,
            device=self.device)
        final, records = self.actor.play_games(states, self.gen)
        # territory-rule lanes: label dead stones by an area-rule playout
        helper = self.actor.territory_playout(final, self.gen)
        targets = assemble_targets(self.env, final, records, territory_helper=helper)
        games = D.games_to_text(self.env, records, targets)
        n = D.write_chunks(games, str(self.out_dir), self.run_id, seed=self.games_done)
        self._write_sgfs(records, targets)
        self._write_queries(records)
        self.last_round = {
            "moves": len(records),
            "positions": sum(len(g) for g in games),
            "kept_records": sum(int((r.active & ~r.discard).sum()) for r in records),
            "chunks": n,
            "territory_lanes": int((final.rule == TERRITORY_RULE).sum()),
            "helper_steps": self.actor.last_helper_steps,
            "queries": dict(self.actor.last_query_stats),
            "seconds": time.monotonic() - t0,
        }
        self.games_done += self.parallel_games
        self.rounds += 1
        return n

    def _write_sgfs(self, records, targets):
        end = targets["end"].cpu().numpy()
        winner = targets["winner"].cpu().numpy()
        sizes = records[0].states.size.cpu().numpy()
        komis = records[0].states.komi.cpu().numpy()
        cols = [{k: getattr(r, k).cpu().numpy()
                 for k in ("move", "discard", "q_value", "score_lead", "kld", "visits")}
                | {"color": r.states.to_move.cpu().numpy()} for r in records]
        n = self.env.n
        fast_p = self.actor.cfg.fastsearch_playouts
        full_p = self.actor.cfg.playouts
        if not (0 < fast_p < full_p):
            fast_p = full_p
        for i in range(self.parallel_games):
            size = int(sizes[i])
            moves = []
            for t in range(int(end[i])):
                c = cols[t]
                color, mv = int(c["color"][i]), int(c["move"][i])
                if mv >= self.env.pass_action:
                    v = None
                else:
                    y, x = divmod(mv, n)
                    v = y * size + x if (y < size and x < size) else None
                # per-move search stats, black's view: "playouts, visits,
                # eval, score, kld, T|F" (F = fast search, discarded)
                discard = bool(c["discard"][i])
                ev, sc = float(c["q_value"][i]), float(c["score_lead"][i])
                if color == 1:
                    ev, sc = 1.0 - ev, -sc
                comment = "%d, %d, %.2f, %.2f, %.2f, %c" % (
                    fast_p if discard else full_p, int(c["visits"][i]), ev, sc,
                    float(c["kld"][i]), "F" if discard else "T")
                moves.append((color, v, comment))
            result = {1: "B+R", -1: "W+R", 0: "0"}[int(winner[i])]
            text = SGF.game_to_sgf(size, float(komis[i]), moves, result=result)
            idx = self.games_done + i
            (self.out_dir / "sgf" / f"{self.run_id}_{idx:06d}.sgf").write_text(text)

    def _write_queries(self, records):
        """Accumulate NN query counts: with the NN cache, the evaluations
        that were neither cache hits nor in-batch duplicates; without it,
        one a playout and one a root per active lane and move."""
        stats = self.actor.last_query_stats
        if stats is not None and stats["queries"] > 0:
            total = stats["queries"] - stats["hits"] - stats["dups"]
        else:
            total = sum(int(r.active.sum()) * (self.actor.cfg.playouts + 1)
                        for r in records)
        self.total_queries += total
        path = self.out_dir / "net_queries" / f"{self.run_id}.txt"
        path.write_text(f"{self.games_done} {self.total_queries}\n")

    def loop(self, max_games: int):
        """Generate until max_games, reloading weights between rounds."""
        while self.games_done < max_games:
            if self.should_reload():
                self._build_actor()
            self.play_round()
        return self.games_done

