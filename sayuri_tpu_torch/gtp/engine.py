"""GTP agent: one game + network + search, host-driven (PyTorch port of
sayuri_tpu.gtp.engine).

The Agent wraps one game as a batch of one on the port's tensors: the
board commands step the env (the flood kernel on the card), ``genmove``
probes the opening book, takes the root superko purge (and, in the
opening, the symmetric-orbit pruning), computes the root ladder planes,
reuses the retained tree or builds a new one with the root evaluator,
searches in chunks with host polls between them (playout cap, time
budget, KLD gain, timemanage, pending input, full tree), checks the resign
threshold, applies the friendly-pass and capture-all-dead filters and
plays the move. Undo is a host-side stack of states.

Where the JAX package compiles a function per query, the port calls the
same code eagerly: the env's step, legality and superko queries, the
analysis kernel for the hygiene maps (``board_analysis``: its safe area,
score ownership and reach ownership are the functions the JAX package
computes with ``safe_and_ownership`` and ``area_ownership``), and the
search. Random draws (the self-play probes only, with GTP's defaults the
search draws nothing) come from one ``torch.Generator`` seeded from
`seed`, where the JAX package splits a threefry key; the capture-all-dead
pick draws from ``np.random.RandomState(seed)`` in both packages.

The pattern gammas are not ported: the Agent raises when given a patterns
file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.ladder import ladder_planes_batch
from sayuri_tpu_torch.game.state import GoEnv, GoState
from sayuri_tpu_torch.game.types import AREA_RULE, C_BLACK, C_WHITE, TERRITORY_RULE
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig, _make_lcb_z_table
from sayuri_tpu_torch.models import symmetry as S
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn

COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"  # GTP columns skip 'I'


def vertex_to_gtp(v, size):
    if v is None:
        return "pass"
    if v >= size * size or v < 0:
        return "pass"
    y, x = divmod(int(v), size)
    return f"{COLS[x]}{y + 1}"


def gtp_to_vertex(s, size):
    s = s.strip().lower()
    if s in ("pass", "p"):
        return size * size
    if s == "resign":
        return "resign"
    col = COLS.lower().index(s[0])
    row = int(s[1:]) - 1
    if not (0 <= col < size and 0 <= row < size):
        raise ValueError(f"vertex {s} out of board")
    return row * size + col


def _np(t):
    return t.detach().cpu().numpy()


class Agent:
    """Single-game engine instance. `net`: a SayuriNet (weightless
    without one); `device`: where the game and the search live;
    `compute_dtype`: the forward's dtype (bf16 on the card when None)."""

    def __init__(
        self,
        boardsize: int = 19,
        komi: float = 7.5,
        playouts: int = 400,
        net=None,
        search_cfg: SearchConfig | None = None,
        max_nodes: int | None = None,
        seed: int = 0,
        ponder: bool = False,
        kldgain_per_node: float = 0.0,
        kldgain_interval: int = 0,
        chunk: int = 16,
        friendly_pass: bool = False,
        capture_all_dead: bool = False,
        patterns_file: str | None = None,
        use_rollout: bool = False,
        policy_temp: float = 1.0,
        root_policy_temp: float = -1.0,
        suppress_pass_factor: float = 0.1667,
        use_stm_winrate: bool = False,
        use_optimistic_policy: bool = False,
        timemanage: str = "off",
        ponder_factor: int = 100,
        symm_pruning: bool = False,
        device="cuda",
        compute_dtype: torch.dtype | None = None,
    ):
        if patterns_file:
            raise ValueError("patterns files (pattern gammas) are not supported by the "
                             "PyTorch port yet")
        self.device = torch.device(device)
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.playouts = playouts
        self.seed = seed
        self.net = None if net is None else net.to(self.device).eval()
        self.search_cfg = search_cfg or SearchConfig(max_nodes=max_nodes or (playouts + 16))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.book = None  # optional opening book (game/book.py)
        # host-side search control
        self.ponder_enabled = ponder
        self.kldgain_per_node = kldgain_per_node
        self.kldgain_interval = kldgain_interval
        self.chunk = chunk
        self.reuse_tree = True
        # post-search move hygiene (off by default)
        self.friendly_pass = friendly_pass
        self.capture_all_dead = capture_all_dead
        self.use_rollout = use_rollout
        self.policy_temp = float(policy_temp)
        # the root follows policy_temp unless set explicitly
        self.root_policy_temp = float(root_policy_temp)
        self.suppress_pass_factor = float(suppress_pass_factor)
        self.use_stm_winrate = bool(use_stm_winrate)
        self.use_optimistic_policy = bool(use_optimistic_policy)
        # early-stop time management (off/on/fast/keep)
        self.timemanage = timemanage
        self.ponder_factor = max(1, int(ponder_factor))
        # root symmetry pruning in the opening
        self.symm_pruning = bool(symm_pruning)
        self._np_rng = np.random.RandomState(seed)
        self.last_stats = None   # the stats of the last think()
        self._build(boardsize, komi)

    # -- construction / reconstruction --

    def _build(self, size: int, komi: float, rule: int = AREA_RULE):
        self.env = GoEnv(n=size)
        self.size = size
        self.komi = komi
        self.rule = rule
        self._build_eval_fns()
        self.state = self._new_state()
        self.history: list[GoState] = []
        self.moves: list[tuple[int, int]] = []  # (color, vertex)
        # territory-rule dead-stone map from the last area playout
        self._territory_helper = None
        self._drop_tree()

    def _new_state(self):
        return self.env.new_batch(1, komi=self.komi, rule=self.rule, device=self.device)

    def _build_eval_fns(self):
        root_eval_fn = None
        if self.net is not None:
            # search queries use a random symmetry per leaf; the debug
            # probes (raw_nn, wdl_rating) the direct evaluator, and neither
            # suppresses pass
            sym = "random"
            leaf_head = "optimistic_prob" if self.use_optimistic_policy else "prob"
            kw = dict(compute_dtype=self.compute_dtype)
            self.eval_fn = make_eval_fn(
                self.env, self.net, symmetry=sym, policy_temp=self.policy_temp,
                policy_head=leaf_head, suppress_pass_factor=self.suppress_pass_factor,
                use_stm_winrate=self.use_stm_winrate, **kw)
            # the root is always evaluated with the normal policy head and
            # root_policy_temp
            root_temp = (self.root_policy_temp if self.root_policy_temp > 0
                         else self.policy_temp)
            if leaf_head != "prob" or root_temp != self.policy_temp:
                root_eval_fn = make_eval_fn(
                    self.env, self.net, symmetry=sym, policy_temp=root_temp,
                    policy_head="prob", suppress_pass_factor=self.suppress_pass_factor,
                    use_stm_winrate=self.use_stm_winrate, **kw)
            self.eval_fn_direct = make_eval_fn(
                self.env, self.net, symmetry=0, policy_temp=self.policy_temp,
                suppress_pass_factor=0.0, **kw)
            self.eval_fn_avg = make_eval_fn(
                self.env, self.net, symmetry="average", policy_temp=self.policy_temp,
                suppress_pass_factor=0.0, **kw)
            self.has_net = True
        else:
            self.eval_fn = make_dummy_eval_fn(
                self.env, suppress_pass_factor=self.suppress_pass_factor)
            self.eval_fn_direct = self.eval_fn
            self.eval_fn_avg = self.eval_fn
            self.has_net = False
        if self.use_rollout:
            from sayuri_tpu_torch.mcts.rollout import wrap_eval_with_rollout

            self.eval_fn = wrap_eval_with_rollout(self.env, self.eval_fn)
        self.mcts = MCTS(self.env, self.eval_fn, self.search_cfg, root_eval_fn=root_eval_fn)
        self._sp_actor = None
        self._playout_actor = None

    def rebuild_search(self):
        """A new MCTS for a changed search config (the NN cache size); the
        game state stays."""
        self.mcts = MCTS(self.env, self.eval_fn, self.search_cfg,
                         root_eval_fn=self.mcts.root_eval_fn)
        self._sp_actor = None
        self._playout_actor = None
        self._drop_tree()

    def _drop_tree(self):
        """Forget the retained search tree."""
        self._tree = None
        self._ctx = None
        self._tree_moves = 0
        self._last_reused = False

    def _set_to_move(self, color: int):
        self.state = self.state.replace(to_move=torch.full_like(self.state.to_move, color))

    def set_handicap(self, k: int):
        """After the handicap stones: white moves next, and `k` feeds the
        area rule's komi penalty."""
        self.state = self.state.replace(
            to_move=torch.ones_like(self.state.to_move),
            handicap=torch.full_like(self.state.handicap, k))

    def handicap(self) -> int:
        return int(self.state.handicap[0])

    # -- game commands --

    def clear_board(self):
        self.state = self._new_state()
        self.history = []
        self.moves = []
        self._territory_helper = None
        self._drop_tree()

    def set_boardsize(self, size: int):
        from sayuri_tpu_torch.ops.analysis import MAX_N

        if self.device.type == "cuda" and size > MAX_N:
            # the board kernels hold at most a 19x19 buffer
            raise ValueError(f"board size {size} is larger than the kernels' {MAX_N}")
        self._build(size, self.komi, self.rule)

    def set_komi(self, komi: float):
        self.komi = komi
        self.state = self.state.replace(komi=torch.full_like(self.state.komi, komi))
        self._drop_tree()  # node values depend on komi

    def set_rule(self, rule: int):
        self.rule = rule
        self.state = self.state.replace(rule=torch.full_like(self.state.rule, rule))
        self._drop_tree()

    def to_move(self) -> int:
        return int(self.state.to_move[0])

    def play(self, color: int, vertex: int):
        """Play a move (forcing the side to move as GTP play does)."""
        if self.to_move() != color:
            self._set_to_move(color)
            # the retained tree's edges assume the natural side to move
            self._drop_tree()
        self.history.append(self.state)
        self.state = self.env.step(self.state, torch.tensor([vertex], dtype=torch.int32))
        self.moves.append((color, vertex))

    def undo(self):
        if self.history:
            self.state = self.history.pop()
            self.moves.pop()
            self._drop_tree()

    def legal_mask(self) -> np.ndarray:
        """[A] bool legality for the side to move (no superko filter)."""
        return _np(self.env.legal_action_mask(self.state))[0]

    def is_legal(self, color: int, vertex: int) -> bool:
        st = self.state.replace(to_move=torch.full_like(self.state.to_move, color))
        return bool(_np(self.env.legal_action_mask(st))[0, vertex])

    def stones(self) -> np.ndarray:
        return _np(self.state.stones[0])

    # -- search --

    def _ladders(self, states):
        return {"ladders": ladder_planes_batch(states.stones, states.size, states.ko)}

    def _superko_mask(self):
        return self.env.superko_action_mask(self.state)

    def _symm_prune_keep(self):
        """[A] bool keep-mask pruning symmetric duplicate root moves in the
        opening: each vertex's orbit key is the lexicographic min over the
        8 dihedral symmetries of symmetry_hash(board, s) ^
        zobrist_key(mover, T_s(vertex)); only the lowest-index member of
        each orbit is kept. Capture effects on the hash are ignored. The
        hash words are 32-bit values held in int64, so the comparisons are
        unsigned as in the JAX package."""
        n = self.size
        dev = self.device
        stones = self.state.stones[0]
        tm = self.to_move()
        cells = B._zobrist_cells(n, str(dev))                       # [2, 3, n*n]
        keys = cells[:, C_BLACK] if tm == 0 else cells[:, C_WHITE]  # [2, n*n]
        best = None
        for s in range(8):
            base = B.position_hash(S.transform_planes(stones[:, :, None], s)[:, :, 0])
            # the stone played at v lands at T_s(v) in the transformed
            # frame: the inverse transform of the key planes puts keys[T_s(v)]
            # at v
            k_s = S.inverse_transform_planes(keys.T.reshape(n, n, 2), s).reshape(n * n, 2).T
            h = base[:, None] ^ k_s                                 # [2, n*n]
            if best is None:
                best = h
            else:
                better = (h[0] < best[0]) | ((h[0] == best[0]) & (h[1] < best[1]))
                best = torch.where(better[None], h, best)
        same = (best[0][:, None] == best[0][None, :]) & (best[1][:, None] == best[1][None, :])
        idx = torch.arange(n * n, device=dev)
        earlier = same & (idx[None, :] < idx[:, None])
        keep_board = ~earlier.any(1)
        return torch.cat([keep_board, torch.ones((1,), dtype=torch.bool, device=dev)])

    def _prepare_root(self, prior_mask=None):
        """Reuse or rebuild the root tree for the current position.
        Returns (tree, ctx). `prior_mask` ([1, A] bool, True = keep) is
        ANDed with the superko purge mask; a move restriction forces a new
        tree."""
        mask = ~self._superko_mask()
        if self.symm_pruning and len(self.moves) <= self.size:
            # opening-only root orbit pruning
            mask = mask & self._symm_prune_keep()[None]
        if prior_mask is not None:
            mask = mask & torch.as_tensor(prior_mask, device=self.device)
            self._drop_tree()
        delta = len(self.moves) - self._tree_moves
        if self.reuse_tree and self._tree is not None and 0 <= delta <= 2:
            tree, ctx = self._tree, self._ctx
            self._last_reused = delta == 0
            for i in range(delta):
                action = self.moves[self._tree_moves + i][1]
                k = self._tree_moves + i + 1
                new_state = self.history[k] if k < len(self.history) else self.state
                ctx = self._ladders(new_state)
                tree, reused = self.mcts.advance_root(
                    tree, torch.tensor([action], device=self.device), new_state,
                    self._gen, prior_mask=mask, ctx=ctx)
                self._last_reused = bool(reused[0])
        else:
            ctx = self._ladders(self.state)
            tree = self.mcts.init_tree(self.state, self._gen, prior_mask=mask, ctx=ctx)
            self._last_reused = False
        self._tree = tree
        self._ctx = ctx
        self._tree_moves = len(self.moves)
        return tree, ctx

    def _one_reasonable_move(self, tree, done, cap_left, elapsed, budget):
        """True when exactly one root child can still matter: every other
        child can neither catch the visit leader with the playouts that
        remain nor beat the leader's LCB (the timemanage early stop)."""
        visits = _np(self.mcts.root_child_visits(tree))[0]
        prior = _np(tree.prior[0, 0])
        cand = prior > 0
        if cand.sum() <= 1:
            return True
        est = cap_left
        remaining = max(budget - elapsed, 0.0)
        est = min(est, int(round(remaining * done / max(elapsed, 1e-9))))
        top = visits.max()
        lcb = _np(self.mcts.root_lcb_scores(tree))[0]
        q = _np(self.mcts.root_child_q(
            tree, torch.tensor([self.to_move()], device=self.device)))[0]
        visited = visits > 0
        toplcb = lcb[visited].max() if visited.any() else -np.inf
        good = (visits + est >= top) | (visited & (q >= toplcb))
        bad_cnt = int((cand & ~good).sum())
        return bad_cnt == int(cand.sum()) - 1

    def think(self, playouts=None, time_budget=None, analyze_cb=None, analyze_interval=0.0,
              prior_mask=None, stop_check=None, tm_allowed=False):
        """Search the current position with the stop conditions: playout
        cap, wall-clock budget, KLD-gain plateau, pending input, a full
        tree, timemanage and only one legal move. The search runs in chunks
        with host polls between them (a device sync each). Returns (tree,
        stats)."""
        playouts = playouts or self.playouts
        t0 = time.monotonic()
        tree, ctx = self._prepare_root(prior_mask)
        start_visits = int(tree.stats[0, 0, 0])

        # only-one-move early exit
        legal_count = int((tree.prior[0, 0] > 0).sum())
        only_one = legal_count <= 1

        chunk = max(1, min(self.chunk, playouts))
        done = 0
        prev_kld_visits = start_visits
        prev_kld_policy = None
        next_analyze = t0 + analyze_interval if analyze_cb and analyze_interval else None
        stopped_by = "cap"
        while done < playouts:
            if only_one and done > 0:
                stopped_by = "only_move"
                break
            if stop_check is not None and stop_check():
                stopped_by = "input"
                break
            if time_budget is not None and time.monotonic() - t0 >= time_budget:
                stopped_by = "time"
                break
            # tree full: visits could still accumulate but no new nodes
            if int(tree.next_free[0]) >= self.search_cfg.max_nodes:
                stopped_by = "tree_full"
                break
            tree = self.mcts.run(tree, chunk, ctx=ctx)
            done += chunk
            self._tree = tree

            # timemanage early stop (the mode gating is the loop's)
            if (tm_allowed and self.timemanage != "off" and time_budget is not None
                    and done >= 100):
                el = time.monotonic() - t0
                if el >= 1.0 and self._one_reasonable_move(tree, done, playouts - done, el,
                                                           time_budget):
                    stopped_by = "timemanage"
                    break

            if next_analyze is not None and time.monotonic() >= next_analyze:
                analyze_cb(tree)
                next_analyze = time.monotonic() + analyze_interval

            # KLD-gain stop over the root visit distribution
            if self.kldgain_per_node > 0 and self.kldgain_interval > 0:
                visits_now = int(tree.stats[0, 0, 0])
                vdiff = visits_now - prev_kld_visits
                if vdiff >= self.kldgain_interval:
                    dist = _np(self.mcts.root_child_visits(tree)).astype(np.float64)[0]
                    dist = np.maximum(dist / max(dist.sum(), 1.0), 1e-8)
                    if prev_kld_policy is not None:
                        kld = float(np.sum(dist * np.log(dist / prev_kld_policy)))
                        if kld / vdiff < self.kldgain_per_node:
                            prev_kld_visits = visits_now
                            prev_kld_policy = dist
                            stopped_by = "kldgain"
                            break
                    prev_kld_visits = visits_now
                    prev_kld_policy = dist

        visits = int(tree.stats[0, 0, 0])
        elapsed = time.monotonic() - t0
        self._tree = tree
        self.last_stats = {"playouts": done, "visits": visits, "time": elapsed,
                           "stopped_by": stopped_by, "reused": self._last_reused}
        return tree, dict(self.last_stats)

    def ponder(self, stop_check, max_playouts=None):
        """Search the opponent's position on their time; `stop_check()` ->
        True aborts. The grown tree is kept for the next think()."""
        if not self.ponder_enabled:
            return None
        max_playouts = max_playouts or self.ponder_factor * self.playouts
        _, stats = self.think(playouts=max_playouts, stop_check=stop_check)
        return stats

    def genmove(self, color: int, playouts=None, resign_threshold=0.1, time_budget=None,
                analyze_cb=None, analyze_interval=0.0, tm_allowed=False):
        """Search and play the best move; an opening-book hit skips the
        search. Returns (move or "resign", tree or None)."""
        if self.to_move() != color:
            self._set_to_move(color)
            self._drop_tree()
        if self.book is not None:
            mv = self.book.probe(self.state, self.legal_mask())
            if mv is not None:
                self.play(color, mv)
                return mv, None
        tree, _ = self.think(playouts, time_budget=time_budget, analyze_cb=analyze_cb,
                             analyze_interval=analyze_interval, tm_allowed=tm_allowed)
        best = int(self.mcts.best_move(tree)[0])
        root = _np(tree.stats[0, 0])
        wl_black = float(root[1]) / max(int(root[0]), 1)
        wl = wl_black if color == 0 else 1.0 - wl_black
        if wl < resign_threshold and self.moves:
            return "resign", tree
        if self.friendly_pass or self.capture_all_dead:
            best = self._apply_move_hygiene(best, tree, color)
        self.play(color, best)
        return best, tree

    # -- in-process self-play probes --

    def _selfplay_actor(self):
        """One-lane SelfplayActor with exploration on, for the
        selfplay-genmove / selfplay GTP probes."""
        from sayuri_tpu_torch.selfplay.actor import SelfplayActor, SelfplayConfig

        if self._sp_actor is None:
            self._sp_actor = SelfplayActor(
                self.env, self.mcts,
                SelfplayConfig(playouts=self.playouts,
                               fastsearch_playouts=max(1, self.playouts // 3)))
            self._sp_records = []
            self._sp_lost = torch.zeros((1,), dtype=torch.bool, device=self.device)
        return self._sp_actor

    def selfplay_move(self, color: int):
        """One self-play-policy move from the current position, recorded
        into the training buffer. Returns the vertex played."""
        actor = self._selfplay_actor()
        if self.to_move() != color:
            self._set_to_move(color)
        new_states, record, self._sp_lost, _, move = actor.move_step(
            self.state, self._gen, self._sp_lost)
        self._sp_records.append(record)
        v = int(move[0])
        self.history.append(self.state)
        self.state = new_states
        self.moves.append((color, v))
        self._drop_tree()
        if self.game_over():
            self.update_territory_helper()
        return v

    def game_over(self) -> bool:
        return bool(self.state.terminated[0])

    def dump_training_buffer(self, filename: str):
        """Write the self-play buffer as training-data text."""
        from sayuri_tpu_torch.selfplay import data as D
        from sayuri_tpu_torch.selfplay.actor import assemble_targets

        records = getattr(self, "_sp_records", [])
        if not records:
            raise ValueError("training buffer is empty")
        helper = None
        if self._territory_helper is not None:
            helper = self._territory_helper[None]
        targets = assemble_targets(self.env, self.state, records, territory_helper=helper)
        games = D.games_to_text(self.env, records, targets)
        with open(filename, "w") as f:
            for game in games:
                for pos in game:
                    f.write(pos)

    def clear_training_buffer(self):
        self._sp_records = []
        self._sp_lost = torch.zeros((1,), dtype=torch.bool, device=self.device)

    def gen_openings(self, num_sgfs: int, opening_moves: int, max_attempts: int | None = None):
        """Fair random openings: policy-sampled (temperature 1.2) opening
        sequences kept only when a bounded search rates them within 0.025
        winrate of the empty board's, deduplicated over the 8 symmetries.
        Returns a list of SGF strings; the game state is restored
        afterwards."""
        from sayuri_tpu_torch.game.sgf import game_to_sgf

        size = self.size
        saved = (self.state, list(self.history), list(self.moves))
        out, seen = [], set()

        def sym_hashes(stones):
            hs = []
            for k in range(4):
                r = np.rot90(stones, k)
                for bmat in (r, np.fliplr(r)):
                    h = B.position_hash(torch.from_numpy(bmat.copy())).tolist()
                    hs.append((int(h[0]), int(h[1])))
            return hs

        self.clear_board()
        fair_tree, _ = self.think(playouts=min(self.playouts, 400))
        root = _np(fair_tree.stats[0, 0])
        fair_wl_b = float(root[1]) / max(int(root[0]), 1)
        attempts = 0
        cap = max_attempts if max_attempts is not None else 20 * max(num_sgfs, 1)
        while len(out) < num_sgfs and attempts < cap:
            attempts += 1
            self.clear_board()
            moves = []
            for _ in range(opening_moves):
                evals = self.eval_fn(self.state, None)
                pri = _np(evals.priors)[0][: size * size].astype(np.float64)
                legal = self.legal_mask()[: size * size]
                w = np.where(legal, np.maximum(pri, 1e-12), 0.0)
                w = w ** (1.0 / 1.2)
                if w.sum() <= 0:
                    break
                v = int(self._np_rng.choice(size * size, p=w / w.sum()))
                color = self.to_move()
                self.play(color, v)
                moves.append((color, v, None))
            hs = sym_hashes(self.stones())
            if hs[0] in seen:
                continue
            tree, _ = self.think(playouts=min(self.playouts, 400))
            root = _np(tree.stats[0, 0])
            wl_b = float(root[1]) / max(int(root[0]), 1)
            # compared in the candidate's side-to-move view
            if self.to_move() == 0:
                fair_tm, eval_tm = fair_wl_b, wl_b
            else:
                fair_tm, eval_tm = 1.0 - fair_wl_b, 1.0 - wl_b
            upper = fair_tm + 0.025
            if eval_tm > upper or eval_tm < 1.0 - upper:
                continue
            seen.update(hs)
            out.append(game_to_sgf(size, self.komi, moves))
        self.state, self.history, self.moves = saved
        self._drop_tree()
        return out

    # -- post-search move hygiene --

    def _hygiene_maps(self):
        """(safe [n,n] bool, safe_own [n,n] {-1,0,1}, raw_own [n,n]) of the
        current position, from one analysis-kernel launch on the card (the
        safe area, the score-area ownership and the reach ownership)."""
        from sayuri_tpu_torch.ops.analysis import board_analysis

        s = self.state
        out = board_analysis(s.stones, s.size, s.ko, s.to_move)
        return (_np(out["safe"])[0], _np(out["score_ownership"])[0],
                _np(out["ownership"])[0])

    def _score_black_cleaned(self, cleaned_stones):
        """Final score from black's view after dead-stone removal."""
        st = self.state.replace(stones=torch.as_tensor(
            np.asarray(cleaned_stones), dtype=self.state.stones.dtype,
            device=self.device)[None])
        return float(self.env.final_score(st)[0])

    def dead_alive(self, tree=None):
        """(dead, alive) [n,n] stone masks from the search's root
        ownership; a bounded search runs when no tree is given."""
        from sayuri_tpu_torch.mcts import hygiene as H

        if tree is None:
            tree, _ = self.think(playouts=min(self.playouts, 400))
        color = self.to_move()
        safe, safe_own, _ = self._hygiene_maps()
        own_black = _np(tree.root_ownership[0]).reshape(self.size, self.size)
        owner = H.owner_map(safe, safe_own, own_black, color)
        return H.dead_alive_masks(self.stones(), owner, color)

    def _apply_move_hygiene(self, best, tree, color):
        """Friendly pass + capture-all-dead filters on the chosen move
        (area scoring only)."""
        from sayuri_tpu_torch.mcts import hygiene as H

        if self.rule != AREA_RULE:
            return best
        pass_a = self.size * self.size
        safe, safe_own, raw = self._hygiene_maps()
        stones = self.stones()
        own_black = _np(tree.root_ownership[0]).reshape(self.size, self.size)
        owner = H.owner_map(safe, safe_own, own_black, color)
        last_was_pass = bool(self.moves) and self.moves[-1][1] >= pass_a
        if self.friendly_pass and last_was_pass:
            dead, _ = H.dead_alive_masks(stones, owner, color)
            if H.should_pass(stones, dead, color, len(self.moves), True,
                             self._score_black_cleaned):
                best = pass_a
        if self.capture_all_dead and best == pass_a:
            legal = self.legal_mask()
            sk = _np(self._superko_mask())[0]
            cad = H.capture_all_dead_move(stones, owner, raw, legal, sk, color, self._np_rng)
            if cad is not None:
                best = cad
        return best

    def analysis_data(self, tree, max_moves=10):
        """Per-move stats rows for the analyze commands, ranked by the LCB
        utility; each row carries visits / winrate / drawrate / scorelead /
        prior / lcb / pv, the PV walking best-LCB children."""
        z_table = _make_lcb_z_table()
        child = _np(tree.child[0])    # [N+1, A]
        stats = _np(tree.stats[0])    # [N+1, 8]
        prior = _np(tree.prior[0])    # [N+1, A]
        red = float(np.clip(self.search_cfg.lcb_reduction, 0.0, 1.0))

        def child_rows(node, color):
            """(action, child_idx, visits, rlcb, winrate, draw, score, p)"""
            ch = child[node]
            acts = np.nonzero(ch >= 0)[0]
            rows = []
            cv = 0.0
            for a in acts:
                cv += stats[ch[a], 0]
            cv = max(cv, 1.0)
            sign = 1.0 if color == 0 else -1.0
            for a in acts:
                c = ch[a]
                v = stats[c, 0]
                if v <= 0:
                    continue
                wl_b = stats[c, 1] / v
                mean = wl_b if color == 0 else 1.0 - wl_b
                draw = stats[c, 2] / v
                score = sign * stats[c, 3] / v
                if v <= 1:
                    rlcb = prior[node, a] - 1e6
                else:
                    var = max(stats[c, 4] / (v - 1.0), 0.0)
                    z = z_table[min(max(int(v) - 2, 0), len(z_table) - 1)]
                    lcb = mean - z * np.sqrt(var) / v
                    mixed = lcb + sign * stats[c, 6]
                    rlcb = mixed * (1.0 - red) + red * v / cv
                rows.append((int(a), int(c), int(v), float(rlcb), float(mean), float(draw),
                             float(score), float(prior[node, a])))
            rows.sort(key=lambda r: -r[3])
            return rows

        def pv_from(node, color, first_action, depth=12):
            pv = [first_action]
            cur, col = node, 1 - color
            for _ in range(depth):
                rows = child_rows(cur, col)
                if not rows:
                    break
                a, c = rows[0][0], rows[0][1]
                pv.append(a)
                cur, col = c, 1 - col
            return pv

        color = self.to_move()
        rows = []
        for a, c, v, rlcb, wl, draw, score, p in child_rows(0, color)[:max_moves]:
            rows.append(dict(move=int(a), visits=v, winrate=wl, drawrate=draw, scorelead=score,
                             prior=p, lcb=max(rlcb, 0.0), order=len(rows),
                             pv=pv_from(c, color, a)))
        return rows

    def root_info(self, tree):
        """Root summary for the sayuri analyze header."""
        root = _np(tree.stats[0, 0])
        v = max(int(root[0]), 1)
        color = self.to_move()
        wl_b = float(root[1]) / v
        score_b = float(root[3]) / v
        return dict(visits=v, winrate=wl_b if color == 0 else 1.0 - wl_b,
                    drawrate=float(root[2]) / v,
                    scorelead=score_b if color == 0 else -score_b)

    def ownership(self) -> np.ndarray:
        return _np(self.env.ownership(self.state))[0]

    def update_territory_helper(self):
        """Label dead stones for territory scoring: play the position out
        under the area rule with fast no-exploring searches and keep the
        end position's score-area ownership as the helper."""
        from sayuri_tpu_torch.selfplay.actor import SelfplayActor, SelfplayConfig

        if self.rule != TERRITORY_RULE:
            self._territory_helper = None
            return
        if self._playout_actor is None:
            self._playout_actor = SelfplayActor(
                self.env, self.mcts,
                SelfplayConfig(playouts=max(1, min(self.playouts, 100)),
                               fastsearch_playouts=0))
        helper = self._playout_actor.territory_playout(self.state, self._gen)
        self._territory_helper = helper[0]

    def final_score_str(self) -> str:
        """The final score (the territory helper's on territory-rule games
        once it exists) as GTP prints it."""
        if self.rule == TERRITORY_RULE and self._territory_helper is not None:
            score = float(self.env.final_score_with_helper(
                self.state, self._territory_helper[None])[0])
        else:
            score = float(self.env.final_score(self.state)[0])
        if abs(score) < 1e-4:
            return "0"
        if score > 0:
            return f"B+{abs(score):g}"
        return f"W+{abs(score):g}"

    def raw_nn(self, use_avg: bool = False):
        """Raw network heads at the current position: the direct symmetry,
        or the 8-fold average when `use_avg`."""
        fn = self.eval_fn_avg if use_avg else self.eval_fn_direct
        evals = fn(self.state, None)
        return {k: _np(v)[0] for k, v in evals._asdict().items()}

    def _planes(self):
        """[n, n, 43] encoder planes of the current position, the ladder
        planes included."""
        from sayuri_tpu_torch.models.encoder import encode
        from sayuri_tpu_torch.ops.analysis import board_analysis

        s = self.state
        ana = board_analysis(s.stones, s.size, s.ko, s.to_move)
        lp = ladder_planes_batch(s.stones, s.size, s.ko)
        return encode(self.env, s, lp, ana["libs"], ana["safe"], ana["score_ownership"])

    @torch.no_grad()
    def raw_heads(self):
        """All network outputs (the 5 policy heads and the value heads) at
        the current position, or None without a net."""
        if self.net is None:
            return None
        with torch.autocast(self.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            out = self.net(self._planes())
        return {k: _np(v.float())[0] for k, v in out.items()}

    def eval_children_wl(self, actions):
        """One forward over the children of `actions`: the mover's winrate
        after each."""
        k = len(actions)
        base = self.state.map(lambda x: x.expand((k,) + x.shape[1:]).contiguous())
        children = self.env.step(base, torch.tensor(actions, dtype=torch.int32))
        wl = _np(self.eval_fn_direct(children, None).black_wl)
        if self.to_move() == 1:
            wl = 1.0 - wl
        return wl

    def ladder_planes(self) -> np.ndarray:
        """[n, n, 4] ladder planes of the current position (encoder order:
        death, escapable, atari, take)."""
        s = self.state
        return _np(ladder_planes_batch(s.stones, s.size, s.ko))[0]

    def seki_points(self) -> np.ndarray:
        """[n, n] bool seki map of the current position."""
        from sayuri_tpu_torch.game.analysis import seki_points

        return _np(seki_points(self.state.stones, self.state.size))[0]

    def planes_str(self) -> str:
        """Encoder plane dump (sayuri-planes format)."""
        planes = _np(self._planes())[0]
        size = self.size
        out = ["encoder version: 2"]
        for p in range(planes.shape[-1]):
            out.append(f"plane: {p + 1}")
            for y in range(size):
                row = []
                for x in range(size):
                    v = planes[y, x, p]
                    row.append("     x" if abs(v) < 1e-4 else f"{v:6.2f}")
                out.append("".join(row))
        return "\n".join(out)
