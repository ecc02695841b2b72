"""The port's self-play actor against the JAX package's on one 5x5 game
batch: B=2 (an area lane and a territory lane), a b2c8 net in float32,
Gumbel search with tree reuse and the NN cache, every search a full one
(fast-search probability 0), no random moves, the same draws injected into
both searches (tests/torch_draws.py). Then the port's territory helper
playout (held against the JAX package's in test_torch_helper_playout.py),
the targets from that helper and the chunk text.

- the moves are equal at every ply, and so are every record's positions,
  discard / active flags and visit totals; its floats within 1e-5 (+ 1e-6
  relative);
- assemble_targets with the same helper within 1e-5 (+ 1e-6 relative),
  winner and game ends equal;
- the chunks' integer lines (version, mode, bsize, planes, side to move,
  ownership, result) are byte-identical, their float lines equal after
  parsing within 1e-4;
- write_chunks lays out the same tdata / vdata files.

The playout-cap draw and the random-move pick are tested on the port
alone: their probabilities 0 and 1 here, and their distributions below.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu.selfplay import actor as JA
from sayuri_tpu.selfplay import data as JD
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from sayuri_tpu_torch.selfplay import actor as TA
from sayuri_tpu_torch.selfplay import data as TD
from test_torch_board import assert_states_equal
from test_torch_network import seeded_variables
from torch_draws import Draws, one_torch_thread  # noqa: F401 (fixture)

N, B, PLAYOUTS, MOVES, HELPER_STEPS = 5, 2, 6, 6, 2
# the port's CPU work runs on one thread (the suite runs several workers)
pytestmark = pytest.mark.usefixtures("one_torch_thread")
ATOL, RTOL, TEXT_ATOL = 1e-5, 1e-6, 1e-4
SEARCH = dict(max_nodes=PLAYOUTS + 10, max_depth=8, gumbel=True, gumbel_considered_moves=4,
              nn_cache_size=16)
SELFPLAY = dict(playouts=PLAYOUTS, fastsearch_playouts=3, fastsearch_playouts_prob=0.0,
                resign_discard_prob=0.8)
# line indices of a 53-line position whose values are integers
INT_LINES = [0, 1, 2] + list(range(6, 44)) + [46, 47]


@pytest.fixture(scope="module")
def games():
    net, variables, tnet = seeded_variables(n=N, channels=8, seed=5)
    jenv, env = JEnv(n=N), GoEnv(n=N)
    rules = np.array([AREA_RULE, TERRITORY_RULE], np.int32)
    jm = JMCTS(jenv, JEV.make_eval_fn(jenv, net, variables, symmetry="random"),
               JConfig(**SEARCH))
    tm = MCTS(env, make_eval_fn(env, tnet, symmetry="random"), SearchConfig(**SEARCH))
    jactor = JA.SelfplayActor(jenv, jm, JA.SelfplayConfig(**SELFPLAY))
    tactor = TA.SelfplayActor(env, tm, TA.SelfplayConfig(**SELFPLAY))
    draws = Draws(moves=MOVES + HELPER_STEPS + 2, sims=PLAYOUTS, b=B, a=N * N + 1, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        draws.install(mp)
        js = jenv.new_batch(B, komi=0.5).replace(rule=jnp.asarray(rules))
        jfinal, jrecs = jactor.play_games(js, jax.random.PRNGKey(0), max_moves=MOVES)
        gen = torch.Generator().manual_seed(0)
        ts = env.new_batch(B, komi=0.5, device="cpu").replace(rule=torch.from_numpy(rules))
        final, recs = tactor.play_games(ts, gen, max_moves=MOVES)
        helper = tactor.territory_playout(final, gen, max_steps=HELPER_STEPS)
    jtargets = jax.jit(JA.assemble_targets, static_argnums=(0,))(
        jenv, jfinal, jrecs, jnp.asarray(helper.numpy()))
    targets = TA.assemble_targets(env, final, recs, territory_helper=helper)
    return dict(jenv=jenv, env=env, jfinal=jfinal, final=final, jrecs=jrecs, recs=recs,
                helper=helper, jtargets=jtargets, targets=targets, tactor=tactor)


def _close(want, got, tag, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=RTOL, err_msg=tag)


def test_moves_and_records_match_jax(games):
    jrecs, recs = games["jrecs"], games["recs"]
    assert len(jrecs) == len(recs) == MOVES
    for t, (jr, r) in enumerate(zip(jrecs, recs)):
        np.testing.assert_array_equal(np.asarray(jr.move), r.move.numpy(), err_msg=f"ply {t}")
        assert_states_equal(jr.states, r.states, f"ply {t}")
        for f in ("discard", "active", "visits"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                          getattr(r, f).numpy(), err_msg=f"ply {t}: {f}")
        for f in ("target_policy", "q_value", "score_lead", "q_stddev", "score_stddev",
                  "kld"):
            _close(getattr(jr, f), getattr(r, f), f"ply {t}: {f}")
    assert_states_equal(games["jfinal"], games["final"], "final")
    assert not any(bool(r.discard.any()) for r in recs)
    assert all(int(r.visits.min()) > 0 for r in recs)
    q = games["tactor"].last_query_stats
    assert q["queries"] > 0 and q["hits"] > 0


def test_targets_match_jax(games):
    """The targets from the port's helper ownership (the territory lane's
    dead strings removed before scoring) in both packages."""
    assert games["tactor"].last_helper_steps == HELPER_STEPS
    jt, t = games["jtargets"], games["targets"]
    assert set(jt) == set(t)
    for k in ("winner", "end"):
        np.testing.assert_array_equal(np.asarray(jt[k]), t[k].numpy(), err_msg=k)
    for k in jt:
        _close(jt[k], t[k], k)


def _positions(games_text):
    return [p.strip("\n").split("\n") for g in games_text for p in g]


def test_chunk_text_matches_jax(games, tmp_path):
    jtext = JD.games_to_text(games["jenv"], games["jrecs"], games["jtargets"])
    text = TD.games_to_text(games["env"], games["recs"], games["targets"])
    want, got = _positions(jtext), _positions(text)
    assert len(want) == len(got) == B * MOVES
    for i, (w, g) in enumerate(zip(want, got)):
        assert len(w) == len(g) == 53
        for ln in range(53):
            if ln in INT_LINES:
                assert w[ln] == g[ln], (i, ln)
            else:
                _close([float(x) for x in w[ln].split()],
                       [float(x) for x in g[ln].split()], f"position {i} line {ln}",
                       TEXT_ATOL)
    # write_chunks: the same files in tdata / vdata, 53 lines a position
    JD.write_chunks(jtext, str(tmp_path / "jax"), "run", seed=3)
    n = TD.write_chunks(text, str(tmp_path / "port"), "run", seed=3)
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.gz"))
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*.gz"))
    assert n == len(files) == B
    for f in files:
        with gzip.open(tmp_path / "port" / f, "rt") as fh:
            assert fh.read().count("\n") == 53 * MOVES


@pytest.mark.parametrize("prob,lost", [(0.75, False), (0.75, True), (0.0, False),
                                       (1.0, False)])
def test_playout_cap_share(prob, lost):
    """The fast-search share follows the playout-cap probability (raised
    for lanes that already lost); budgets are the two playout counts."""
    actor = TA.SelfplayActor(GoEnv(n=N), None, TA.SelfplayConfig(
        playouts=150, fastsearch_playouts=50, fastsearch_playouts_prob=prob,
        resign_discard_prob=0.8))
    b = 8192
    use_fast, budget = actor.playout_cap(torch.full((b,), lost),
                                         torch.Generator().manual_seed(1))
    want = 1.0 - (1.0 - prob) * 0.2 if lost else prob
    assert abs(float(use_fast.float().mean()) - want) < 0.02
    assert torch.equal(budget, torch.where(use_fast, 50, 150))


def test_random_move_distribution():
    """Random moves follow visits^(1/temp) over the children above the
    low-visit cut; pass is excluded where forbidden."""
    cfg = TA.SelfplayConfig(random_moves_temp=0.5, random_min_ratio=0.1,
                            random_min_visits=1)
    actor = TA.SelfplayActor(GoEnv(n=N), None, cfg)
    b = 8192
    visits = torch.zeros((b, N * N + 1))
    visits[:, [3, 7, 11]] = torch.tensor([4.0, 20.0, 40.0])   # 4 <= 0.1 * 40: cut
    visits[:, -1] = 30.0
    forbid = torch.arange(b) % 2 == 0
    move, ok = actor.random_move(visits, forbid, torch.Generator().manual_seed(2))
    assert bool(ok.all())
    w = torch.tensor([20.0, 40.0, 30.0]) ** 2                    # temp 0.5
    for lanes, cols, weights in ((~forbid, [7, 11, N * N], w),
                                 (forbid, [7, 11], w[:2])):
        freq = torch.stack([(move[lanes] == c).float().mean() for c in cols])
        np.testing.assert_allclose(freq.numpy(), (weights / weights.sum()).numpy(),
                                   atol=0.025)
