"""The port's GTP loop (gtp/loop.py, gtp/engine.py) against the JAX
package's on one seeded v5 weight file (a b2c16 net, float32 on the CPU)
at 5x5, both loops shared by every test of the file (the JAX loop compiles
its functions for each board size and search config: the 7x7 games and
the handicap commands are in test_torch_gtp_7x7.py, the first-pass bonus
in test_torch_gtp_bonus.py).

The same command script goes through both loops. Answers are equal string
for string: the admin commands, play, genmove (tree reuse on and off),
undo, is_legal, showboard, komi, rules, final_score, final_status_list,
printsgf / loadsgf, sayuri-setoption, and genmove with symmetric-orbit
pruning and with the friendly-pass and capture-all-dead filters. The
kata-analyze / lz-analyze rows at a fixed playout count (no interval: one
emission at the end of the search, so the rows do not depend on the
clock) give the same words (moves, orders, PVs) and numbers within 1e-4
(lz rows: their integer 1/10000 units within one).

The probes that run no search, over positions set up with play:
sayuri-planes, gogui-seki, gogui-rules_legal_moves, gogui-ladder_map,
gogui-rules_board, color, is_legal, final_score (both rules) and
sayuri-raw_nn with its 8-fold average; equal answers, sayuri-raw_nn's
numbers within 1e-4 (plus the printed precision).

The search control of the Agent (think / ponder / genmove): the stop
conditions that the JAX package's tests check (tests/test_gtp_search.py).
Where the stop does not depend on the clock (the KLD gain, stop_check and
ponder, a full tree, the one-reasonable-move test of timemanage, the
playout cap), `stopped_by`, the playout counts and the root visits are
equal; the time budget stops the port's search too. Tree reuse carries
visits into the next search (equal counts), undo drops the tree, and the
analyze avoid / allow restriction binds the root (equal rows)."""

import numpy as np
import pytest
import torch

from gtp_pair import NUMERIC, answer, assert_same_answers, loop_pair, write_weights
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PLAYOUTS = 24


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = write_weights(tmp_path_factory.mktemp("w") / "b2c16-5.txt", 5, seed=2)
    return loop_pair(path, boardsize=5, komi=5.5, playouts=PLAYOUTS, max_nodes=96, chunk=8)


ADMIN = ["protocol_version", "name", "version", "list_commands", "known_command genmove",
         "known_command frobnicate", "frobnicate", "query_boardsize", "get_komi", "rules",
         "gogui-rules_game_id", "gogui-rules_board_size", "gogui-analyze_commands",
         "genpatterns a b", "gogui-gammas_heatmap", "gogui-gammas_rating"]


def test_admin_commands(pair):
    jloop, tloop = pair
    for line in ADMIN:
        if line.startswith(("genpatterns", "gogui-gammas")):
            # the pattern gammas are not ported: a plain failure
            assert answer(tloop, line) == (False, "not supported by the PyTorch port yet")
        else:
            assert answer(jloop, line) == answer(tloop, line), line


def test_game_script(pair, tmp_path):
    n = 5
    jloop, tloop = pair
    c = "C3"
    sgf = tmp_path / "game.sgf"
    script = [
        "boardsize %d" % n, "clear_board", "komi 5.5", f"play b {c}", "genmove w",
        "is_legal b %s" % c, "is_legal w A1", "showboard", "genmove b", "genmove w",
        "undo", "genmove w", "sayuri-setoption name reuse tree value false", "genmove b",
        "sayuri-setoption name reuse tree value true", "genmove w", "genmove b",
        "final_score", "final_status_list dead", "final_status_list alive",
        "gogui-rules_side_to_move", "kata-analyze b interval 0", "lz-analyze w maxmoves 4", "sayuri-analyze b 0",
        f"printsgf {sgf}", "printsgf", "rules japanese", "final_score", "rules chinese",
        "play w pass", "genmove b", "undo", "undo",
        "sayuri-setoption name playouts value 6", "genmove b",
        f"sayuri-setoption name playouts value {PLAYOUTS}", "showboard",
    ]
    assert_same_answers(jloop, tloop, script, numeric=NUMERIC)
    assert answer(jloop, f"loadsgf {sgf}") == answer(tloop, f"loadsgf {sgf}") == (True, "")
    assert_same_answers(jloop, tloop, ["showboard", "printsgf", "genmove w", "final_score"],
                        numeric=NUMERIC)


def test_hygiene_and_pruning_options(pair):
    """genmove with symmetric-orbit pruning in the opening, and with the
    friendly-pass and capture-all-dead filters after a pass (the options
    are the Agent's flags, as --symm-pruning, --friendly-pass and
    --capture-all-dead set them)."""
    jloop, tloop = pair
    for loop in (jloop, tloop):
        loop.agent.symm_pruning = True
    assert_same_answers(jloop, tloop, ["clear_board", "genmove b", "genmove w", "play b C3",
                                       "genmove w", "genmove b"])
    for loop in (jloop, tloop):
        loop.agent.symm_pruning = False
        loop.agent.friendly_pass = loop.agent.capture_all_dead = True
    script = ["clear_board"] + [f"genmove {'bw'[i % 2]}" for i in range(10)]
    script += ["play w pass", "genmove b", "genmove w", "genmove b", "final_score"]
    try:
        assert_same_answers(jloop, tloop, script)
    finally:
        for loop in (jloop, tloop):
            loop.agent.friendly_pass = loop.agent.capture_all_dead = False


# ---- the probes that run no search ----

NET_PROBES = ("sayuri-raw_nn",)
# the JAX loop compiles each network probe anew at every call: those run
# on the first position only
PROBES = ["gogui-seki", "gogui-rules_legal_moves", "gogui-ladder_map", "gogui-rules_board",
          "final_score", "rules japanese", "final_score", "rules chinese"]
NET = ["sayuri-planes", "sayuri-raw_nn", "sayuri-raw_nn avg"]


# a seki corner (the simple no-eye seki of test_seki.py, cut to 5x5), a
# ladder, and an atari
POSITIONS = [
    ["play b C3", "play w D4", "play b B2"],
    ["play b A5", "play b A4", "play b A3", "play b B3", "play b C3", "play b C4",
     "play b C5", "play w D5", "play w D4", "play w D3", "play w D2", "play w C2",
     "play w B2", "play w A2"],
    ["play b C3", "play w B3", "play b C2", "play w C4", "play b D4", "play w B2",
     "play b pass", "play w D3"],
]


@pytest.mark.parametrize("i", range(len(POSITIONS)))
def test_probes(pair, i):
    jloop, tloop = pair
    script = ["clear_board"] + POSITIONS[i] + ["color C3", "is_legal b E5"] + PROBES
    assert_same_answers(jloop, tloop, script + (NET if i == 0 else []), numeric=NET_PROBES)


# ---- search control ----

def _root_visits(agent, tree):
    v = agent.mcts.root_child_visits(tree)
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)[0]


def _both(pair, fn):
    jloop, tloop = pair
    return fn(jloop.agent), fn(tloop.agent)


def _same_stats(want, got, keys=("playouts", "visits", "stopped_by", "reused")):
    assert {k: want[1][k] for k in keys} == {k: got[1][k] for k in keys}
    np.testing.assert_array_equal(_root_visits(*want[2]), _root_visits(*got[2]))


def _think(agent, **kw):
    tree, stats = agent.think(**kw)
    return tree, stats, (agent, tree)


def test_playout_cap_and_tree_reuse(pair):
    def run(a):
        a.clear_board()
        a.genmove(0)
        # the opponent-side think advances through our move; the best
        # child was expanded, so its subtree carries over
        return _think(a, playouts=8)
    want, got = _both(pair, run)
    _same_stats(want, got)
    assert got[1]["reused"] and got[1]["visits"] > 9 and got[1]["stopped_by"] == "cap"


def test_kldgain_stop(pair):
    def run(a):
        a.clear_board()
        a.kldgain_per_node, a.kldgain_interval = 10.0, 4
        try:
            return _think(a, playouts=80)
        finally:
            a.kldgain_per_node, a.kldgain_interval = 0.0, 0
    want, got = _both(pair, run)
    _same_stats(want, got)
    assert got[1]["stopped_by"] == "kldgain" and got[1]["playouts"] < 80


def test_stop_check_and_ponder(pair):
    def run(a):
        a.clear_board()
        a.genmove(0)
        a.ponder_enabled = True
        calls = []
        stats = a.ponder(stop_check=lambda: calls.append(1) or len(calls) > 2,
                         max_playouts=64)
        a.ponder_enabled = False
        # the opponent answers with the move pondered on: the tree advances
        best = a.mcts.best_move(a._tree)
        a.play(1, int(np.asarray(best.numpy() if isinstance(best, torch.Tensor)
                                 else best)[0]))
        tree, stats2 = a.think(playouts=8)
        return stats, stats2, (a, tree)
    want, got = _both(pair, run)
    assert want[0] == {**got[0], "time": want[0]["time"]}
    assert got[0]["stopped_by"] == "input" and got[0]["playouts"] == 16
    _same_stats(want, got)
    assert got[1]["reused"]


def test_tree_full(pair):
    def run(a):
        a.clear_board()
        return _think(a, playouts=10**4)
    want, got = _both(pair, run)
    _same_stats(want, got)
    assert got[1]["stopped_by"] == "tree_full"


def test_time_budget(pair):
    _, tloop = pair
    a = tloop.agent
    a.clear_board()
    _, stats = a.think(playouts=10**6, time_budget=0.3)
    assert stats["stopped_by"] in ("time", "tree_full")
    assert stats["playouts"] < 10**5


def test_one_reasonable_move(pair):
    """timemanage's test on equal trees, over playouts left and budgets."""
    def run(a):
        a.clear_board()
        a.play(0, 12)
        tree, _ = a.think(playouts=24)
        return [a._one_reasonable_move(tree, 24, left, el, budget)
                for left in (0, 4, 40) for el, budget in ((1.0, 1.1), (1.0, 5.0))]
    want, got = _both(pair, run)
    assert want == got and any(got) and not all(got)


def test_undo_drops_tree(pair):
    _, tloop = pair
    a = tloop.agent
    a.clear_board()
    a.genmove(0)
    assert a._tree is not None
    a.undo()
    assert a._tree is None


def test_analyze_avoid_allow(pair):
    jloop, tloop = pair
    script = ["clear_board", "lz-analyze b interval 0 allow b A1,B1 50",
              "kata-analyze b interval 0 avoid b C3,B3,C2 50", "genmove b"]
    assert_same_answers(jloop, tloop, script, numeric=NUMERIC)
    answer(tloop, "clear_board")
    _, text = answer(tloop, "lz-analyze b interval 0 allow b A1,B1 50")
    moves = [line.split()[1] for line in text.split("info ")[1:]]
    assert moves and set(moves) <= {"A1", "B1"}
