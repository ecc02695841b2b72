"""GTP v2 protocol loop (PyTorch port of sayuri_tpu.gtp.loop, a copy with
the JAX package's direct array work routed through the Agent).

Commands are dispatched to the Agent; analysis commands emit the
lz/kata-style info lines GUIs expect. The command list, the engine's name
and version are the JAX package's.

A handler's exception is a GTP failure (a "?" answer), except where it
comes from the card or the kernels: an exception raised in the kernel
wrappers or the build (``sayuri_tpu_torch.ops``) or a CUDA error passes
through ``execute`` and ends the loop, so that a broken kernel never hides
behind a "?" line.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from sayuri_tpu_torch import __version__
from sayuri_tpu_torch.game import sgf as SGF
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE
from sayuri_tpu_torch.gtp.engine import Agent, _np, gtp_to_vertex, vertex_to_gtp
from sayuri_tpu_torch.gtp.time_control import TimeControl

_OPS_DIR = Path(__file__).resolve().parent.parent / "ops"

KNOWN_COMMANDS = [
    "protocol_version", "name", "version", "known_command", "list_commands",
    "quit", "boardsize", "query_boardsize", "clear_board", "clear_cache",
    "komi", "get_komi", "play", "genmove", "undo", "showboard", "is_legal",
    "color", "final_score", "final_status_list", "time_settings",
    "kgs-time_settings", "time_left", "fixed_handicap", "place_free_handicap",
    "set_free_handicap", "get_handicap", "loadsgf", "printsgf",
    "kgs-game_over", "kgs-chat", "rules", "sayuri-setoption",
    "sayuri-planes", "sayuri-raw_nn", "lz-analyze", "lz-genmove_analyze",
    "kata-analyze", "kata-genmove_analyze", "sayuri-analyze",
    "sayuri-genmove_analyze", "netbench", "benchmark", "genbook",
    "loadbook", "gogui-analyze_commands", "gogui-rules_game_id",
    "gogui-rules_board", "gogui-rules_board_size",
    "gogui-rules_legal_moves", "gogui-rules_side_to_move",
    "gogui-rules_final_result", "gogui-policy_heatmap",
    "gogui-ownership_heatmap", "gogui-seki", "selfplay-genmove", "selfplay",
    "dump_training_buffer", "clear_training_buffer", "genpatterns",
    "genopenings", "help", "analyze", "genmove_analyze", "debug_search",
    "debug_moves", "gogui-wdl_rating", "gogui-policy_rating",
    "gogui-ownership_influence", "gogui-book_rating",
    "gogui-gammas_heatmap", "gogui-gammas_rating", "gogui-ladder_map",
    "gogui-rank_selection",
]

_HANDICAP_9 = {  # standard star points for fixed_handicap on odd boards
    2: [(3, 15), (15, 3)],
    3: [(3, 15), (15, 3), (15, 15)],
    4: [(3, 3), (3, 15), (15, 3), (15, 15)],
    5: [(3, 3), (3, 15), (9, 9), (15, 3), (15, 15)],
    6: [(3, 3), (3, 15), (9, 3), (9, 15), (15, 3), (15, 15)],
    7: [(3, 3), (3, 15), (9, 3), (9, 9), (9, 15), (15, 3), (15, 15)],
    8: [(3, 3), (3, 9), (3, 15), (9, 3), (9, 15), (15, 3), (15, 9), (15, 15)],
    9: [(3, 3), (3, 9), (3, 15), (9, 3), (9, 9), (9, 15), (15, 3), (15, 9),
        (15, 15)],
}


def _star_points(size, k):
    """Scale the 19x19 star layout to `size` (Board::ComputeStarPoints)."""
    edge = 3 if size >= 13 else 2
    mid = size // 2
    lut = {3: edge, 9: mid, 15: size - 1 - edge}
    pts = []
    for y, x in _HANDICAP_9.get(k, []):
        pts.append((lut[y], lut[x]))
    return pts


def _device_fault(exc) -> bool:
    """Did `exc` come from the card or the kernels: a CUDA error, or an
    exception raised inside sayuri_tpu_torch/ops (kernel wrappers, build)?"""
    cuda_errors = (torch.cuda.OutOfMemoryError,) + tuple(
        e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)
    if isinstance(exc, cuda_errors):
        return True
    if isinstance(exc, RuntimeError) and "CUDA" in str(exc):
        return True
    tb = exc.__traceback__
    while tb is not None:
        if Path(tb.tb_frame.f_code.co_filename).resolve().parent == _OPS_DIR:
            return True
        tb = tb.tb_next
    return False


def _color_arg(tok):
    tok = tok.lower()
    if tok in ("b", "black"):
        return 0
    if tok in ("w", "white"):
        return 1
    return None


class GtpLoop:
    def __init__(self, agent: Agent | None = None, const_time: float = 0.0,
                 lag_buffer: float = 0.0, resign_threshold: float = 0.1,
                 kgs_hint: str = "", logfile: str | None = None,
                 **agent_kwargs):
        self.agent = agent or Agent(**agent_kwargs)
        self.time = TimeControl()
        # --const-time bounds the budget when the clock is infinite
        # (search.cc:313-319); --lag-buffer seeds the adaptive buffer
        # (config.cc:81, search.cc:438-455)
        self.const_time = float(const_time)
        self.lag_buffer_floor = max(float(lag_buffer), 0.0)
        self.time.lag_buffer = self.lag_buffer_floor
        self.resign_threshold = min(1.0, max(0.0, float(resign_threshold)))
        # --kgs-hint is appended to the verbose version string shown to
        # KGS users (gtp.h:83-92)
        self.kgs_hint = kgs_hint
        # --logfile tees the GTP dialogue (config.cc --logfile semantics)
        self._log = open(logfile, "a") if logfile else None
        self.running = True

    # ------------------------------------------------------------------

    def execute(self, line: str) -> tuple[bool, str]:
        """Process one GTP command; returns (ok, response body)."""
        line = line.split("#", 1)[0].strip()
        if not line:
            return True, ""
        parts = line.split()
        cmd_id = ""
        if parts[0].isdigit():
            cmd_id = parts[0]
            parts = parts[1:]
        if not parts:
            return True, ""
        cmd, args = parts[0], parts[1:]
        handler = getattr(self, "_cmd_" + cmd.replace("-", "_"), None)
        if handler is None:
            return False, "unknown command"
        try:
            return handler(args)
        except Exception as e:  # GTP failure, keep the loop alive
            if _device_fault(e):
                raise
            return False, str(e)

    def run(self, instream=sys.stdin, outstream=sys.stdout):
        """Main loop. Analysis commands stream info lines until the next
        command arrives; with pondering on, the engine searches the
        opponent's time between commands. A reader thread feeds a queue
        (it only reads the input; all card work stays on this thread), so
        a pending input is a queue peek."""
        import queue
        import threading

        q: queue.Queue = queue.Queue()

        def reader():
            for line in instream:
                q.put(line)
            q.put(None)

        threading.Thread(target=reader, daemon=True).start()
        self._inq = q

        def tee(text):
            if self._log is not None:
                self._log.write(text)
                self._log.flush()

        can_ponder = False
        while self.running:
            if (
                can_ponder
                and self.agent.ponder_enabled
                and q.empty()
                and self.agent.moves
            ):
                # one ponder session per idle period
                self.agent.ponder(stop_check=lambda: not q.empty())
                can_ponder = False
            line = q.get()
            if line is None:
                break
            tee(line)
            stripped = line.split("#", 1)[0].strip()
            parts = stripped.split()
            cmd_id = parts[0] if parts and parts[0].isdigit() else ""
            ok, body = self.execute(line)
            if not stripped:
                continue
            prefix = ("=" if ok else "?") + cmd_id
            if isinstance(body, StreamBody):
                outstream.write(f"{prefix}\n")
                outstream.flush()
                tee(f"{prefix}\n")

                def emit(text):
                    outstream.write(text)
                    outstream.flush()
                    tee(text)

                body.run(emit, lambda: not q.empty())
                outstream.write("\n")
                outstream.flush()
                tee("\n")
            else:
                outstream.write(f"{prefix} {body}\n\n")
                outstream.flush()
                tee(f"{prefix} {body}\n\n")
            can_ponder = True
            if not self.running:
                break

    # -- administrative ------------------------------------------------

    def _cmd_protocol_version(self, args):
        return True, "2"

    def _cmd_name(self, args):
        return True, "sayuri-tpu"

    def _cmd_version(self, args):
        if self.kgs_hint:
            return True, f"{__version__}. {self.kgs_hint}"
        return True, __version__

    def _cmd_known_command(self, args):
        return True, "true" if args and args[0] in KNOWN_COMMANDS else "false"

    def _cmd_list_commands(self, args):
        return True, "\n".join(KNOWN_COMMANDS)

    def _cmd_quit(self, args):
        self.running = False
        return True, ""

    # -- board setup ---------------------------------------------------

    def _cmd_boardsize(self, args):
        size = int(args[0])
        if not (2 <= size <= 25):
            return False, "invalid board size"
        self.agent.set_boardsize(size)
        return True, ""

    def _cmd_query_boardsize(self, args):
        return True, str(self.agent.size)

    def _cmd_clear_board(self, args):
        self.agent.clear_board()
        return True, ""

    def _cmd_clear_cache(self, args):
        return True, ""

    def _cmd_komi(self, args):
        self.agent.set_komi(float(args[0]))
        return True, ""

    def _cmd_get_komi(self, args):
        return True, f"{self.agent.komi:g}"

    def _cmd_rules(self, args):
        if args:
            rule = args[0].lower()
            if rule in ("chinese", "area", "tromp-taylor"):
                self.agent.set_rule(AREA_RULE)
            elif rule in ("japanese", "territory"):
                self.agent.set_rule(TERRITORY_RULE)
            else:
                return False, "unknown rules"
            return True, ""
        return True, (
            "chinese" if self.agent.rule == AREA_RULE else "japanese"
        )

    # -- moves ---------------------------------------------------------

    def _cmd_play(self, args):
        color = _color_arg(args[0])
        if color is None:
            return False, "invalid color"
        v = gtp_to_vertex(args[1], self.agent.size)
        if v == "resign":
            return True, ""
        if v < self.agent.size**2 and not self.agent.is_legal(color, v):
            return False, "illegal move"
        self.agent.play(color, v)
        return True, ""

    def _genmove_budget(self, color):
        """Per-move wall-clock budget from the clock state
        (Search::ThinkBestMove + GetThinkingTime, search.cc:305-319)."""
        if self.const_time > 0 and self.time.is_infinite():
            return self.const_time
        budget = self.time.thinking_time(
            color, self.agent.size, len(self.agent.moves)
        )
        return None if budget == float("inf") else budget

    def _timed_genmove(self, color, **kw):
        """genmove under the clock: budget + consumption + the adaptive
        lag-buffer adjustment (Search::UpdateLagBuffer, search.cc:438-455)."""
        import time as _t

        budget = self._genmove_budget(color)
        beffect = self.time.buffer_effect(
            color, self.agent.size, len(self.agent.moves)
        )
        # timemanage mode gating (search.cc:1477-1496): "on" needs an
        # accumulating clock, "keep" only saves time in the byo phase,
        # "fast" always saves; const-time clocks never accumulate
        tm = self.agent.timemanage
        tm_allowed = (
            tm != "off"
            and budget is not None
            and not self.time.is_infinite()
            and not (
                tm == "on"
                and (
                    self.const_time > 0
                    or not self.time.can_accumulate(color)
                )
            )
            and not (
                tm == "keep"
                and (self.const_time > 0 or not self.time.in_byo[color])
            )
        )
        t0 = _t.monotonic()
        move, tree = self.agent.genmove(
            color,
            time_budget=budget,
            resign_threshold=self.resign_threshold,
            tm_allowed=tm_allowed,
            **kw,
        )
        elapsed = _t.monotonic() - t0
        self.time.took_time(color, elapsed)
        if budget is not None and not self.time.is_infinite():
            self.time.update_lag_buffer(
                budget, beffect, elapsed, self.lag_buffer_floor
            )
        return move, tree

    def _cmd_genmove(self, args):
        color = (
            _color_arg(args[0]) if args else self.agent.to_move()
        )
        if color is None:
            return False, "invalid color"
        move, _ = self._timed_genmove(color)
        if move == "resign":
            return True, "resign"
        return True, vertex_to_gtp(
            move if move < self.agent.size**2 else None, self.agent.size
        )

    def _cmd_undo(self, args):
        self.agent.undo()
        return True, ""

    def _cmd_is_legal(self, args):
        color = _color_arg(args[0])
        v = gtp_to_vertex(args[1], self.agent.size)
        if color is None or v == "resign":
            return False, "invalid is_legal"
        if v >= self.agent.size**2:
            return True, "1"
        return True, "1" if self.agent.is_legal(color, v) else "0"

    def _cmd_color(self, args):
        v = gtp_to_vertex(args[0], self.agent.size)
        s = self.agent.stones()
        y, x = divmod(v, self.agent.size)
        val = int(s[y, x])
        return True, {0: "empty", 1: "black", 2: "white"}[val]

    def _cmd_showboard(self, args):
        s = self.agent.stones()
        size = self.agent.size
        rows = []
        for y in range(size - 1, -1, -1):
            row = [".XO"[int(s[y, x])] for x in range(size)]
            rows.append(f"{y + 1:2d} " + " ".join(row))
        rows.append("   " + " ".join(COLS_FOR(size)))
        return True, "\n" + "\n".join(rows)

    # -- scoring -------------------------------------------------------

    def _cmd_final_score(self, args):
        return True, self.agent.final_score_str()

    def _cmd_final_status_list(self, args):
        """Search-based life/death verdicts, one string per line (a bounded
        search, then the alive or dead strings)."""
        from sayuri_tpu_torch.mcts.hygiene import chain_labels_np

        which = args[0] if args else "dead"
        size = self.agent.size
        s = self.agent.stones()
        if self.agent.has_net:
            dead_mask, alive_mask = self.agent.dead_alive()
        else:
            # no network: raw reach-area ownership heuristic
            own = self.agent.ownership().reshape(size, size)
            stone_color = s - 1
            dead_mask = ((stone_color == 0) & (own < 0)) | (
                (stone_color == 1) & (own > 0)
            )
            dead_mask &= s > 0
            alive_mask = (s > 0) & ~dead_mask
        mask = dead_mask if which == "dead" else alive_mask
        labels = chain_labels_np(s)
        lines = []
        import numpy as np

        for lbl in np.unique(labels[mask & (labels >= 0)]):
            verts = [
                vertex_to_gtp(int(y) * size + int(x), size)
                for y, x in zip(*np.nonzero(labels == lbl))
            ]
            lines.append(" ".join(verts))
        return True, "\n".join(lines)

    # -- handicap ------------------------------------------------------

    def _cmd_fixed_handicap(self, args):
        k = int(args[0])
        pts = _star_points(self.agent.size, k)
        if not pts or len(pts) != k:
            return False, "invalid handicap"
        verts = []
        for y, x in pts:
            v = y * self.agent.size + x
            self.agent.play(0, v)
            verts.append(vertex_to_gtp(v, self.agent.size))
        # handicap: white moves next; the count feeds the area-rule komi
        # penalty
        self.agent.set_handicap(k)
        return True, " ".join(verts)

    def _cmd_place_free_handicap(self, args):
        return self._cmd_fixed_handicap(args)

    def _cmd_set_free_handicap(self, args):
        for tok in args:
            v = gtp_to_vertex(tok, self.agent.size)
            self.agent.play(0, v)
        self.agent.set_handicap(len(args))
        return True, ""

    def _cmd_get_handicap(self, args):
        return True, str(self.agent.handicap())

    # -- time ----------------------------------------------------------

    def _cmd_time_settings(self, args):
        self.time.time_settings(float(args[0]), float(args[1]), int(args[2]))
        return True, ""

    def _cmd_kgs_time_settings(self, args):
        system = args[0]
        vals = [float(a) for a in args[1:]] + [0, 0, 0]
        self.time.kgs_time_settings(system, vals[0], vals[1], vals[2])
        return True, ""

    def _cmd_time_left(self, args):
        color = _color_arg(args[0])
        self.time.time_left(color, float(args[1]), int(args[2]))
        return True, ""

    def _cmd_kgs_game_over(self, args):
        return True, ""

    def _cmd_kgs_chat(self, args):
        return True, "I'm a TPU"

    # -- sgf -----------------------------------------------------------

    def _cmd_loadsgf(self, args):
        games = SGF.parse_file(args[0])
        if not games:
            return False, "invalid SGF file"
        game = games[0]
        movenum = int(args[1]) if len(args) > 1 else 10**9
        self.agent.set_boardsize(game.board_size())
        self.agent.set_komi(game.komi())
        for color, yx in game.handicap_stones():
            self.agent.play(color, yx[0] * game.board_size() + yx[1])
        for i, (color, vertex) in enumerate(game.moves()):
            if i >= movenum:
                break
            v = vertex if vertex is not None else self.agent.size**2
            self.agent.play(color, v)
        return True, ""

    def _cmd_printsgf(self, args):
        moves = [
            (c, v if v < self.agent.size**2 else None)
            for c, v in self.agent.moves
        ]
        text = SGF.game_to_sgf(self.agent.size, self.agent.komi, moves)
        if args:
            with open(args[0], "w") as f:
                f.write(text)
            return True, ""
        return True, text

    # -- engine debug / options ----------------------------------------

    def _cmd_sayuri_planes(self, args):
        return True, self.agent.planes_str()

    def _cmd_sayuri_raw_nn(self, args):
        # optional symmetry arg: 0-7 (direct, transformed) or "avg"
        # (8-fold ensemble average, gtp.cc:610-620)
        use_avg = bool(args) and args[0].lower() in ("avg", "8")
        evals = self.agent.raw_nn(use_avg=use_avg)
        out = []
        size = self.agent.size
        probs = evals["priors"]
        out.append("policy:")
        for y in range(size):
            out.append(
                " ".join(f"{probs[y * size + x]:.4f}" for x in range(size))
            )
        out.append(f"pass: {probs[-1]:.4f}")
        out.append(f"black wl: {evals['black_wl']:.4f}")
        out.append(f"black score: {evals['black_score']:.2f}")
        return True, "\n".join(out)

    def _cmd_sayuri_setoption(self, args):
        # sayuri-setoption name <key> value <value> (gtp.cc:1395-1456)
        kv = " ".join(args)
        try:
            name = kv.split("name", 1)[1].split("value")[0].strip()
            value = kv.split("value", 1)[1].strip()
        except IndexError:
            return False, "syntax: sayuri-setoption name <n> value <v>"
        low = value.lower()
        if name == "playouts":
            self.agent.playouts = max(0, int(value))
        elif name == "reuse tree":
            if low not in ("true", "false"):
                return False, "invalid value"
            self.agent.reuse_tree = low == "true"
        elif name == "pondering":
            if low not in ("true", "false"):
                return False, "invalid value"
            self.agent.ponder_enabled = low == "true"
        elif name == "resign threshold":
            self.resign_threshold = min(1.0, max(0.0, float(value)))
        elif name == "scoring rule":
            if low == "territory":
                self.agent.set_rule(TERRITORY_RULE)
            elif low == "area":
                self.agent.set_rule(AREA_RULE)
            else:
                return False, "invalid rule"
        elif name == "threads":
            pass  # no-op: the array search has no worker threads
        elif name == "batch size":
            pass  # no-op: leaf batch = game batch under jit
        elif name == "kldgain per node":
            self.agent.kldgain_per_node = float(value)
        elif name == "kldgain interval":
            self.agent.kldgain_interval = int(value)
        elif name == "friendly pass":
            if low not in ("true", "false"):
                return False, "invalid value"
            self.agent.friendly_pass = low == "true"
        elif name == "capture all dead":
            if low not in ("true", "false"):
                return False, "invalid value"
            self.agent.capture_all_dead = low == "true"
        elif name == "lag buffer":
            self.lag_buffer_floor = max(0.0, float(value))
            self.time.lag_buffer = self.lag_buffer_floor
        elif name == "const time":
            self.const_time = max(0.0, float(value))
        elif name in ("cache size", "cache memory mib"):
            # NN cache sets; rebuild the search with the new cache
            import dataclasses as _dc

            self.agent.search_cfg = _dc.replace(
                self.agent.search_cfg, nn_cache_size=max(0, int(value))
            )
            self.agent.rebuild_search()
        elif name == "gammas policy factor":
            self.agent.gammas_policy_factor = min(1.0, max(0.0, float(value)))
            self.agent.refresh_gammas()
        elif name == "patterns file":
            from sayuri_tpu_torch.pattern.gammas import GammasDict

            try:
                self.agent.gammas = GammasDict.load(value)
            except OSError:
                return False, "cannot load patterns file"
            self.agent.refresh_gammas()
        else:
            return False, "invalid option name"
        return True, ""

    # -- gogui extensions (gtp.cc:767-1161 family) ---------------------

    def _cmd_gogui_analyze_commands(self, args):
        # the reference's gfx menu (gtp.cc:767-789) + our dboard extras
        return True, "\n".join(
            [
                "gfx/Win-Draw-Loss Rating/gogui-wdl_rating",
                "dboard/Policy Heatmap/gogui-policy_heatmap",
                "gfx/Normal Policy Rating/gogui-policy_rating normal",
                "gfx/Opponent Policy Rating/gogui-policy_rating opponent",
                "gfx/Soft Policy Rating/gogui-policy_rating soft",
                "gfx/Soft Opponent Policy Rating/"
                "gogui-policy_rating softopponent",
                "gfx/Optimistic Policy Rating/"
                "gogui-policy_rating optimistic",
                "dboard/Ownership Heatmap/gogui-ownership_heatmap",
                "gfx/Ownership Influence/gogui-ownership_influence 0",
                "gfx/MCTS Ownership Influence/gogui-ownership_influence 400",
                "gfx/Book Rating/gogui-book_rating",
                "gfx/Gammas Heatmap/gogui-gammas_heatmap",
                "gfx/Gammas Rating/gogui-gammas_rating",
                "gfx/Ladder Map/gogui-ladder_map",
                "gfx/Rank Selection/gogui-rank_selection",
                "dboard/Seki Points/gogui-seki",
                "string/Final Result/gogui-rules_final_result",
            ]
        )

    def _cmd_gogui_rules_game_id(self, args):
        return True, "Go"

    def _cmd_gogui_rules_board_size(self, args):
        return True, str(self.agent.size)

    def _cmd_gogui_rules_side_to_move(self, args):
        return True, "black" if self.agent.to_move() == 0 else "white"

    def _cmd_gogui_rules_board(self, args):
        s = self.agent.stones()
        size = self.agent.size
        rows = []
        for y in range(size - 1, -1, -1):
            rows.append(
                " ".join(".XO"[int(s[y, x])] for x in range(size))
            )
        return True, "\n".join(rows)

    def _cmd_gogui_rules_legal_moves(self, args):
        mask = self.agent.legal_mask()
        size = self.agent.size
        out = [
            vertex_to_gtp(v, size)
            for v in range(size * size)
            if mask[v]
        ]
        out.append("pass")
        return True, " ".join(out)

    def _cmd_gogui_rules_final_result(self, args):
        return True, self.agent.final_score_str()

    def _cmd_gogui_policy_heatmap(self, args):
        evals = self.agent.raw_nn()
        size = self.agent.size
        probs = evals["priors"][: size * size]
        rows = []
        for y in range(size - 1, -1, -1):
            rows.append(
                " ".join(
                    f"{probs[y * size + x]:.3f}" for x in range(size)
                )
            )
        return True, "\n".join(rows)

    def _cmd_gogui_ownership_heatmap(self, args):
        evals = self.agent.raw_nn()
        size = self.agent.size
        own = evals["black_ownership"][: size * size]
        rows = []
        for y in range(size - 1, -1, -1):
            rows.append(
                " ".join(f"{own[y * size + x]:+.2f}" for x in range(size))
            )
        return True, "\n".join(rows)

    def _cmd_gogui_seki(self, args):
        """Seki-point dboard."""
        size = self.agent.size
        seki = self.agent.seki_points()
        rows = []
        for y in range(size - 1, -1, -1):
            rows.append(
                " ".join(
                    "1" if seki[y, x] else "0" for x in range(size)
                )
            )
        return True, "\n".join(rows)


    # -- generic aliases + tree debug probes (gtp.cc:389-417,567,744-766)

    def _cmd_help(self, args):
        return self._cmd_list_commands(args)

    def _cmd_analyze(self, args):
        return True, self._analyze_stream("sayuri-analyze", args, False)

    def _cmd_genmove_analyze(self, args):
        return True, self._analyze_stream("sayuri-genmove_analyze", args, True)

    def _cmd_debug_search(self, args):
        """Run a fresh search of N playouts for tree inspection
        (gtp.cc:744-759: release tree, clear cache, search)."""
        if not args or not args[0].lstrip("-").isdigit() or int(args[0]) < 1:
            return False, "invalid playouts"
        self.agent._drop_tree()
        self.agent.think(playouts=int(args[0]))
        return True, "done"

    def _cmd_debug_moves(self, args):
        """Per-move root statistics for the given vertices
        (Search::GetDebugMoves, gtp.cc:760-766)."""
        import numpy as np

        size = self.agent.size
        try:
            moves = [gtp_to_vertex(a, size) for a in args]
        except ValueError:
            return False, "invalid vertex"
        tree, _ = self.agent.think(playouts=self.agent.playouts)
        visits = _np(tree.visits)[0]
        child = _np(tree.child)[0, 0]
        prior = _np(tree.prior)[0, 0]
        stats = _np(tree.stats)[0]
        lines = []
        for v in moves:
            a = size * size if v < 0 else v
            c = child[a]
            line = f"move {vertex_to_gtp(a, size)} prior {prior[a]:.4f}"
            if c >= 0:
                nv = max(visits[c], 1)
                wl = stats[c, 1] / nv
                line += f" visits {int(visits[c])} wl {wl:.4f}"
            else:
                line += " visits 0"
            lines.append(line)
        return True, "\n".join(lines)

    # -- gogui rating/influence family (gtp.cc:789-1010) ----------------

    @staticmethod
    def _gogui_color(val, vtx):
        """COLOR #rrggbb VTX (gogui_helper.cc:120-127 value->hue ramp)."""
        import colorsys

        val = min(1.0, max(0.0, float(val)))
        # hue 240 (blue, 0.0) -> 0 (red, 1.0), like ValueToColor
        r, g, b = colorsys.hsv_to_rgb((1.0 - val) * 240.0 / 360.0, 1.0, 1.0)
        return f"COLOR #{int(r*255):02x}{int(g*255):02x}{int(b*255):02x} {vtx}"

    @staticmethod
    def _gogui_label(val, vtx):
        val = min(1.0, max(0.0, float(val)))
        return f"LABEL {vtx} {int(val * 100.0)}"

    def _cmd_gogui_wdl_rating(self, args):
        """Win-draw-loss labels: one BATCHED forward over all candidate
        children instead of the reference's serial play/eval/undo loop
        (gtp.cc:789-817)."""
        import numpy as np

        evals = self.agent.raw_nn()
        size = self.agent.size
        nn = size * size
        probs = evals["priors"][:nn]
        cand = [i for i in range(nn) if probs[i] > 1.0 / nn]
        legal = self.agent.legal_mask()
        cand = [i for i in cand if legal[i]]
        if not cand:
            return True, ""
        wl = self.agent.eval_children_wl(cand)
        out = [
            self._gogui_label(1.0 - w, vertex_to_gtp(v, size))
            for v, w in zip(cand, wl)
        ]
        return True, "\n".join(out)

    def _cmd_gogui_policy_rating(self, args):
        """LABEL ratings for moves above average policy + pass text
        (gtp.cc:860-930). Optional offset arg selects the policy head:
        normal|opponent|soft|softopponent|optimistic."""
        size = self.agent.size
        nn = size * size
        offset = args[0] if args else "normal"
        key = {
            "normal": "prob", "opponent": "aux_prob", "soft": "soft_prob",
            "softopponent": "soft_aux_prob", "optimistic": "optimistic_prob",
        }.get(offset)
        if key is None:
            return False, "invalid policy offset"
        heads = self.agent.raw_heads()
        if heads is not None:
            probs = heads[key]
        else:  # dummy network: only the search prior is available
            probs = self.agent.raw_nn()["priors"]
        board, ppass = probs[:nn], float(probs[nn])
        best, lines = -1, []
        for i in range(nn):
            if board[i] > 1.0 / nn:
                if best < 0 or board[i] > board[best]:
                    best = i
                lines.append(
                    self._gogui_label(board[i], vertex_to_gtp(i, size))
                )
        var = ""
        if best >= 0:
            c = "b" if self.agent.to_move() == 0 else "w"
            var = f"VAR {c} {vertex_to_gtp(best, size)}\n"
        body = var + "\n".join(lines)
        body += f"\nTEXT pass {100.0 * ppass:3.2f}%"
        return True, body

    def _cmd_gogui_ownership_influence(self, args):
        """INFLUENCE map from the net (0 playouts) or MCTS root ownership
        (gtp.cc:976-1004)."""
        import numpy as np

        playouts = int(args[0]) if args and args[0].isdigit() else 0
        size = self.agent.size
        nn = size * size
        if playouts > 0:
            self.agent._drop_tree()
            tree, _ = self.agent.think(playouts=playouts)
            own = _np(tree.root_ownership)[0][:nn]
        else:
            own = self.agent.raw_nn()["black_ownership"][:nn]
        if self.agent.to_move() == 1:
            own = -own
        parts = ["INFLUENCE"]
        for i in range(nn):
            parts.append(f"{vertex_to_gtp(i, size)} {own[i]:.1f}")
        return True, " ".join(parts)

    def _cmd_gogui_book_rating(self, args):
        """Book move frequencies as labels."""
        from sayuri_tpu_torch.game.book import _hash_key

        book = self.agent.book
        if book is None:
            return True, ""
        moves = book.table.get(_hash_key(self.agent.state))
        if not moves:
            return True, ""
        size = self.agent.size
        total = sum(moves.values()) or 1
        moves = sorted(moves.items(), key=lambda mc: -mc[1])
        c = "b" if self.agent.to_move() == 0 else "w"
        lines = [f"VAR {c} {vertex_to_gtp(int(moves[0][0]), size)}"]
        for v, cnt in moves:
            lines.append(
                self._gogui_label(cnt / total, vertex_to_gtp(int(v), size))
            )
        return True, "\n".join(lines)

    def _cmd_gogui_gammas_heatmap(self, args):
        """Pattern-gamma policy colors (gtp.cc:954-975)."""
        gp = self.agent.gammas_policy_map()
        if gp is None:
            return False, "no patterns loaded"
        size = self.agent.size
        out = []
        for i in range(size * size):
            v = float(gp[i])
            if v > 1e-4:
                v = v ** 0.5
            out.append(self._gogui_color(v, vertex_to_gtp(i, size)))
        return True, "\n".join(out)

    def _cmd_gogui_gammas_rating(self, args):
        gp = self.agent.gammas_policy_map()
        if gp is None:
            return False, "no patterns loaded"
        size = self.agent.size
        nn = size * size
        best, lines = -1, []
        for i in range(nn):
            if gp[i] > 1.0 / nn:
                if best < 0 or gp[i] > gp[best]:
                    best = i
                lines.append(self._gogui_label(gp[i], vertex_to_gtp(i, size)))
        out = []
        if best >= 0:
            c = "b" if self.agent.to_move() == 0 else "w"
            out.append(f"VAR {c} {vertex_to_gtp(best, size)}")
        return True, "\n".join(out + lines)

    def _cmd_gogui_ladder_map(self, args):
        """Ladder feature colors: atari .2 / take .4 / escapable .8 /
        death 1.0."""
        size = self.agent.size
        planes = self.agent.ladder_planes()
        # encoder plane order: [death, escapable, atari, take]
        colors = {0: 1.0, 1: 0.8, 2: 0.2, 3: 0.4}
        out = []
        for i in range(size * size):
            y, x = divmod(i, size)
            val = 0.0
            for p, c in colors.items():
                if planes[y, x, p] > 0:
                    val = c
                    break
            out.append(self._gogui_color(val, vertex_to_gtp(i, size)))
        return True, "\n".join(out)

    def _cmd_gogui_rank_selection(self, args):
        """Rank labels of the search's top moves (listed in
        commands_list.h:135; unimplemented in the reference binary — here:
        1-based visit ranking of the root children)."""
        import numpy as np

        size = self.agent.size
        tree, _ = self.agent.think(playouts=self.agent.playouts)
        child = _np(tree.child)[0, 0][: size * size]
        visits = _np(tree.visits)[0]
        pairs = [
            (int(visits[c]), a) for a, c in enumerate(child) if c >= 0
        ]
        pairs.sort(reverse=True)
        out = []
        for rank, (nv, a) in enumerate(pairs[:9], 1):
            if nv > 0:
                out.append(f"LABEL {vertex_to_gtp(a, size)} {rank}")
        return True, "\n".join(out)

    def _cmd_selfplay_genmove(self, args):
        """Self-play-policy move recorded into the training buffer: the
        reference's in-process selfplay probe (gtp.cc:334-347)."""
        color = _color_arg(args[0]) if args else self.agent.to_move()
        move = self.agent.selfplay_move(color)
        return True, vertex_to_gtp(
            move if move < self.agent.size**2 else None, self.agent.size
        )

    def _cmd_selfplay(self, args):
        """Play the rest of the game with the self-play policy, then label
        dead stones for territory scoring (gtp.cc:349-355)."""
        guard = 2 * self.agent.size**2 + 32
        while not self.agent.game_over() and guard > 0:
            self.agent.selfplay_move(self.agent.to_move())
            guard -= 1
        return True, ""

    def _cmd_dump_training_buffer(self, args):
        # (gtp.cc:356-371)
        if not self.agent.game_over():
            return False, "it is not game over yet"
        if not args:
            return False, "invalid file name"
        try:
            self.agent.dump_training_buffer(args[0])
        except ValueError as e:
            return False, str(e)
        return True, ""

    def _cmd_clear_training_buffer(self, args):
        self.agent.clear_training_buffer()
        return True, ""

    def _cmd_genpatterns(self, args):
        """MM-fit spatial/tactical gammas from SGFs (gtp.cc:660-681):
        ``genpatterns SGF_FILE_OR_DIR OUT_FILE [MIN_COUNT]``."""
        if len(args) < 2:
            return False, "file name is empty"
        from sayuri_tpu_torch.pattern.gammas import train_from_sgfs

        src = Path(args[0])
        paths = sorted(src.rglob("*.sgf")) if src.is_dir() else [src]
        min_count = int(args[2]) if len(args) > 2 else 0
        gammas = train_from_sgfs(paths, min_count=min_count, device=self.agent.device)
        gammas.save(args[1])
        return True, f"{len(gammas)} gammas"

    def _cmd_genopenings(self, args):
        """Generate fair random openings as SGFs (gtp.cc:682-743):
        policy-sampled opening moves, kept only when a bounded search
        judges the resulting position within ±0.05 winrate of the empty
        board's, deduplicated by symmetry hash."""
        if not args:
            return False, "directory name is empty"
        from pathlib import Path

        save_dir = Path(args[0])
        save_dir.mkdir(parents=True, exist_ok=True)
        num_sgfs = int(args[1]) if len(args) > 1 else 0
        opening_moves = (
            int(args[2]) if len(args) > 2 else self.agent.size // 2
        )
        names = self.agent.gen_openings(num_sgfs, opening_moves)
        for i, sgf_text in enumerate(names):
            (save_dir / f"{i}.sgf").write_text(sgf_text)
        return True, f"{len(names)} openings"

    def _cmd_genbook(self, args):
        # genbook <sgf_dir> <out_file> (gtp.cc:643-660)
        from pathlib import Path

        from sayuri_tpu_torch.game.book import Book

        if len(args) < 2:
            return False, "syntax: genbook <sgf_dir> <out_file>"
        paths = sorted(Path(args[0]).rglob("*.sgf"))
        book = Book.generate(paths, device=self.agent.device)
        book.save(args[1])
        return True, f"{len(book)} positions"

    def _cmd_loadbook(self, args):
        from sayuri_tpu_torch.game.book import Book

        self.agent.book = Book.load(args[0])
        return True, f"{len(self.agent.book)} positions"

    def _cmd_netbench(self, args):
        import time as _t

        n_evals = int(args[0]) if args else 16
        self.agent.eval_fn(self.agent.state, None)  # warmup/compile
        t0 = _t.monotonic()
        for _ in range(n_evals):
            out = self.agent.eval_fn(self.agent.state, None)
        out.priors.cpu()  # waits for the card
        dt = _t.monotonic() - t0
        return True, f"{n_evals} evals in {dt:.3f}s ({n_evals / dt:.1f}/s)"

    def _cmd_benchmark(self, args):
        playouts = int(args[0]) if args else 200
        import time as _t

        t0 = _t.monotonic()
        tree, stats = self.agent.think(playouts)
        dt = _t.monotonic() - t0
        return True, f"{stats['playouts']} playouts in {dt:.2f}s " \
                     f"({stats['playouts'] / dt:.1f} p/s)"

    # -- analysis ------------------------------------------------------
    # lz-/kata-/sayuri-analyze family with interval streaming and
    # avoid/allow move restrictions (gtp.cc:1166-1390, node.cc:982-1088).

    def _parse_analyze_config(self, cmd, args):
        """Parse analyze options (GtpLoop::ParseAnalysisConfig,
        gtp.cc:1216-1380): [color] [interval-cs] interval N, minmoves N,
        maxmoves N, avoid/allow C vlist untilmove, ownership true."""
        cfg = dict(
            fmt=(
                "sayuri"
                if cmd.startswith("sayuri")
                else "kata" if cmd.startswith("kata") else "lz"
            ),
            color=None,
            interval_cs=0,
            max_moves=20,
            min_moves=0,
            ownership=False,
            moves_ownership=False,
            avoid=[],   # (color, vertex, until_move)
            allow=[],
        )
        i = 0
        while i < len(args):
            tok = args[i].lower()
            i += 1
            if tok.isdigit():
                cfg["interval_cs"] = int(tok)
            elif tok in ("b", "black", "w", "white"):
                cfg["color"] = _color_arg(tok)
            elif tok == "interval" and i < len(args) and args[i].isdigit():
                cfg["interval_cs"] = int(args[i]); i += 1
            elif tok in ("minmoves", "maxmoves") and i < len(args) and \
                    args[i].isdigit():
                cfg["min_moves" if tok == "minmoves" else "max_moves"] = \
                    int(args[i]); i += 1
            elif tok == "ownership" and i < len(args):
                cfg["ownership"] = args[i].lower() == "true"; i += 1
            elif tok == "movesownership" and i < len(args):
                cfg["moves_ownership"] = args[i].lower() == "true"; i += 1
            elif tok in ("avoid", "allow"):
                mcolor, moves, until = None, [], -1
                if i < len(args):
                    mcolor = _color_arg(args[i]); i += 1
                if i < len(args):
                    for text in args[i].split(","):
                        try:
                            moves.append(
                                gtp_to_vertex(text, self.agent.size)
                            )
                        except (ValueError, IndexError):
                            pass
                    i += 1
                if i < len(args) and args[i].isdigit():
                    until = int(args[i]); i += 1
                if mcolor is not None and until >= 0:
                    until_abs = until + len(self.agent.moves) - 1
                    cfg[tok].extend(
                        (mcolor, v, until_abs)
                        for v in moves
                        if v != "resign"
                    )
            elif tok == "reuse" and i < len(args):
                self.agent.reuse_tree = args[i].lower() == "true"; i += 1
        return cfg

    def _analyze_prior_mask(self, cfg):
        """Root move restrictions -> [1, A] keep-mask (the reference
        applies avoid/allow per color up to until_move through the tree,
        node.cc; here they gate the root, where they bind the search)."""
        if not cfg["avoid"] and not cfg["allow"]:
            return None
        A = self.agent.env.num_actions
        move_num = len(self.agent.moves)
        to_move = self.agent.to_move()
        mask = np.ones((1, A), bool)
        allows = [
            v for c, v, until in cfg["allow"]
            if c == to_move and move_num <= until
        ]
        if allows:
            mask[:] = False
            for v in allows:
                mask[0, v] = True
        for c, v, until in cfg["avoid"]:
            if c == to_move and move_num <= until:
                mask[0, v] = False
        return mask

    def _format_analysis(self, tree, cfg):
        """One analysis emission (Node::ToAnalysisString formats,
        node.cc:995-1088)."""
        rows = self.agent.analysis_data(tree, max_moves=cfg["max_moves"])
        size = self.agent.size
        out = []
        fmt = cfg["fmt"]

        def own_str(tag):
            own = _np(tree.root_ownership)[0]
            if self.agent.to_move() == 1:
                own = -own
            vals = []
            for y in range(size - 1, -1, -1):
                for x in range(size):
                    vals.append(f"{own[y * size + x]:.6f}")
            return f"{tag} " + " ".join(vals)

        if fmt == "sayuri":
            root = self.agent.root_info(tree)
            head = (
                f"info move null visits {root['visits']} "
                f"winrate {root['winrate']:.6f} "
                f"drawrate {root['drawrate']:.6f} "
                f"scorelead {root['scorelead']:.6f} "
            )
            if cfg["ownership"]:
                head += own_str("ownership") + " "
            out.append(head.rstrip())
        for r in rows:
            mv = vertex_to_gtp(
                r["move"] if r["move"] < size**2 else None, size
            )
            pv = " ".join(
                vertex_to_gtp(v if v < size**2 else None, size)
                for v in r["pv"]
            )
            if fmt == "sayuri":
                out.append(
                    f"info move {mv} visits {r['visits']} "
                    f"winrate {r['winrate']:.6f} "
                    f"drawrate {r['drawrate']:.6f} "
                    f"scorelead {r['scorelead']:.6f} "
                    f"prior {r['prior']:.6f} "
                    f"lcb {min(1.0, r['lcb']):.6f} "
                    f"order {r['order']} pv {pv}"
                )
            elif fmt == "kata":
                out.append(
                    f"info move {mv} visits {r['visits']} "
                    f"winrate {r['winrate']:.6f} "
                    f"scoreLead {r['scorelead']:.6f} "
                    f"prior {r['prior']:.6f} "
                    f"lcb {min(1.0, r['lcb']):.6f} "
                    f"order {r['order']} pv {pv}"
                )
            else:
                out.append(
                    f"info move {mv} visits {r['visits']} "
                    f"winrate {min(10000, int(10000 * r['winrate']))} "
                    f"scoreLead {r['scorelead']:.6f} "
                    f"prior {min(10000, int(10000 * r['prior']))} "
                    f"lcb {min(10000, int(10000 * r['lcb']))} "
                    f"order {r['order']} pv {pv}"
                )
        if cfg["ownership"] and fmt != "sayuri":
            out.append(own_str("ownership"))
        return " ".join(out)

    def _analyze_stream(self, cmd, args, genmove):
        cfg = self._parse_analyze_config(cmd, args)
        color = (
            cfg["color"]
            if cfg["color"] is not None
            else self.agent.to_move()
        )
        prior_mask = self._analyze_prior_mask(cfg)
        interval_s = cfg["interval_cs"] / 100.0
        loop = self

        class _Body(StreamBody):
            def run(self, emit, input_pending):
                agent = loop.agent

                def cb(tree):
                    emit(loop._format_analysis(tree, cfg) + "\n")

                if genmove:
                    move, tree = loop._timed_genmove(
                        color,
                        analyze_cb=cb if interval_s > 0 else None,
                        analyze_interval=interval_s,
                    )
                    if tree is not None:
                        cb(tree)
                    mv = (
                        "resign"
                        if move == "resign"
                        else vertex_to_gtp(
                            move if move < agent.size**2 else None,
                            agent.size,
                        )
                    )
                    emit(f"play {mv}\n")
                else:
                    tree, _ = agent.think(
                        playouts=(
                            agent.playouts if self.bounded else 10**9
                        ),
                        analyze_cb=cb if interval_s > 0 else None,
                        analyze_interval=interval_s,
                        prior_mask=prior_mask,
                        stop_check=input_pending,
                    )
                    cb(tree)

        return _Body()

    def _cmd_lz_analyze(self, args):
        return True, self._analyze_stream("lz-analyze", args, False)

    def _cmd_kata_analyze(self, args):
        return True, self._analyze_stream("kata-analyze", args, False)

    def _cmd_sayuri_analyze(self, args):
        return True, self._analyze_stream("sayuri-analyze", args, False)

    def _cmd_lz_genmove_analyze(self, args):
        return True, self._analyze_stream("lz-genmove_analyze", args, True)

    def _cmd_kata_genmove_analyze(self, args):
        return True, self._analyze_stream(
            "kata-genmove_analyze", args, True
        )

    def _cmd_sayuri_genmove_analyze(self, args):
        return True, self._analyze_stream(
            "sayuri-genmove_analyze", args, True
        )


class StreamBody:
    """Marker type: a GTP response that streams lines itself.
    `run(emit, input_pending)` writes info lines until done or until
    `input_pending()` turns True. `collect()` runs one bounded search
    synchronously and returns the emitted text (used by `execute()`
    callers that want a plain response, e.g. tests)."""

    bounded = False

    def run(self, emit, input_pending):  # pragma: no cover - interface
        raise NotImplementedError

    def collect(self) -> str:
        self.bounded = True
        out = []
        self.run(out.append, lambda: False)
        return "".join(out).rstrip("\n")


def COLS_FOR(size):
    from sayuri_tpu_torch.gtp.engine import COLS

    return [COLS[x] for x in range(size)]



def main(argv=None, device="cuda"):
    """``python -m sayuri_tpu_torch.gtp.loop [--boardsize N] [--komi K]
    [--playouts P] [--weights F]``: the GTP engine on stdin / stdout on the
    card (a caller passes ``device="cpu"`` for a CPU run); `F` is a v5
    weight file or a trainer checkpoint, weightless without one."""
    import argparse

    ap = argparse.ArgumentParser(description="sayuri-tpu GTP engine (PyTorch port)")
    ap.add_argument("--boardsize", type=int, default=19)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--playouts", type=int, default=400)
    ap.add_argument("--weights", type=str, default=None)
    args = ap.parse_args(argv)

    kwargs = dict(boardsize=args.boardsize, komi=args.komi, playouts=args.playouts,
                  device=device)
    if args.weights:
        from sayuri_tpu_torch.models import weights_io

        kwargs["net"] = weights_io.load_checkpoint_for_inference(args.weights)[1]
    loop = GtpLoop(**kwargs)
    loop.run(sys.stdin, sys.stdout)
    return loop


if __name__ == "__main__":
    main()
