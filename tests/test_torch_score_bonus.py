"""The first-pass score bonus and the terminal scoring switch of the port's
search (mcts/core.py: MCTS._score_bonus, SearchConfig.first_pass_bonus and
terminal_tt_score) against the JAX package's:

- _score_bonus within 1e-6 on 7x7 parents (random games and the seki
  diagrams of test_torch_seki.py) at every action, with random root
  ownerships, under both rules, some lanes with a pending ko;
- a 5x5 search with first_pass_bonus on the same weights (a b2c16 net,
  float32) from near-end positions whose last move was a pass (so two-pass
  terminals enter the tree): equal root visits and best moves, every tree
  array (black_sb and the stats included) within 1e-5;
- terminal_tt_score on and off (with the bonus) from other such
  positions, the root restricted to pass and two board moves so that
  terminal leaves are visited: equal root visits and best moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn
from test_torch_board import jax_to_torch, random_jax_states
from test_torch_network import seeded_variables
from test_torch_seki import _diagram_boards
from torch_draws import assert_trees_equal, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_score_bonus_matches_jax():
    n = 7
    nn = n * n
    jenv, js, _ = random_jax_states(n=n, b=6, moves=40, seed=13, pass_prob=0.05)
    dia = _diagram_boards(n)
    b0 = js.stones.shape[0]
    stones = np.concatenate([np.asarray(js.stones), dia])
    b = stones.shape[0]
    rng = np.random.RandomState(0)
    ko = np.where(rng.rand(b) < 0.2, rng.randint(0, nn, b), -1).astype(np.int32)
    base = jax.tree.map(lambda x: jnp.concatenate([x, x[np.zeros(len(dia), int)]]), js)
    base = base.replace(stones=jnp.asarray(stones), ko=jnp.asarray(ko),
                        to_move=jnp.asarray(rng.randint(0, 2, b).astype(np.int32)),
                        rule=jnp.asarray(np.where(np.arange(b) % 2, AREA_RULE,
                                                  TERRITORY_RULE).astype(np.int32)))
    # every action of every board: [b * (nn + 1)] lanes
    reps = nn + 1
    parents = jax.tree.map(lambda x: jnp.repeat(x, reps, axis=0), base)
    action = np.tile(np.arange(reps, dtype=np.int32), b)
    own = rng.uniform(-1.0, 1.0, (b * reps, nn)).astype(np.float32)
    own[rng.rand(b * reps, nn) < 0.4] *= 1.0 / np.abs(own).max()   # some near +-1
    own = np.sign(own) * np.minimum(np.abs(own) * 1.3, 1.0)
    jm = JMCTS(jenv, JEV.make_dummy_eval_fn(jenv), JConfig(first_pass_bonus=True))
    want = np.asarray(jax.jit(jm._score_bonus)(parents, jnp.asarray(action),
                                               jnp.asarray(own)))
    tm = MCTS(GoEnv(n=n), make_dummy_eval_fn(GoEnv(n=n)), SearchConfig(first_pass_bonus=True))
    got = tm._score_bonus(jax_to_torch(parents), torch.from_numpy(action),
                          torch.from_numpy(own)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # every branch is reached: the area pass and seki points, the
    # territory penalties, the ko gate
    assert (want > 0).any() and (want < 0).any() and (want == 0).any()
    seki_lanes = np.arange(b0 * reps, b * reps)
    assert (np.abs(want[seki_lanes]) == 0.5).any()


@pytest.fixture(scope="module")
def nets():
    return seeded_variables(n=5, seed=6)


_SEARCHES = {}


def _searches(nets, tt, sims=20):
    """(jitted JAX search, port MCTS) with first_pass_bonus, shared across
    tests (one JAX compile per terminal_tt_score setting)."""
    if tt not in _SEARCHES:
        net, variables, tnet = nets
        cfg = dict(max_nodes=sims + 8, max_depth=12, first_pass_bonus=True,
                   terminal_tt_score=tt)
        jenv, env = random_jax_states(n=5, b=1, moves=0)[0], GoEnv(n=5)
        jm = JMCTS(jenv, JEV.make_eval_fn(jenv, net, variables, symmetry="random",
                                          ladder_mode="off"), JConfig(**cfg))
        tm = MCTS(env, make_eval_fn(env, tnet, symmetry="random", ladder_mode="off"),
                  SearchConfig(**cfg))
        run = jax.jit(lambda s, pm: jm.run(
            jm.init_tree(s, jax.random.PRNGKey(0), prior_mask=pm), sims))
        _SEARCHES[tt] = (jm, run, tm, sims)
    return _SEARCHES[tt]


def _near_end(n=5, b=3, moves=16, seed=7):
    """Near-end 5x5 games whose last move is a pass."""
    jenv, js, _ = random_jax_states(n=n, b=b, moves=moves, seed=seed, pass_prob=0.0)
    js = jax.jit(jax.vmap(jenv.step))(js, jnp.full((b,), n * n, jnp.int32))
    js = js.replace(rule=jnp.asarray(np.array([AREA_RULE, TERRITORY_RULE, AREA_RULE][:b],
                                              np.int32)))
    return js


def _root_mask(js, keep_board):
    """[B, A] root prior mask: pass and the first `keep_board` legal board
    moves of each lane (all legal moves when None)."""
    nn = js.stones.shape[-1] ** 2
    mask = np.ones((js.stones.shape[0], nn + 1), bool)
    if keep_board is not None:
        occupied = np.asarray(js.stones).reshape(len(mask), nn) != 0
        for b in range(len(mask)):
            free = np.nonzero(~occupied[b])[0][keep_board:]
            mask[b, free] = False
    return mask


def test_first_pass_bonus_search_matches_jax(nets):
    jm, run, tm, sims = _searches(nets, False)
    js = _near_end()
    pm = _root_mask(js, None)
    jtree = run(js, jnp.asarray(pm))
    ttree = tm.run(tm.init_tree(jax_to_torch(js), prior_mask=torch.from_numpy(pm)), sims)
    np.testing.assert_array_equal(np.asarray(jm.root_child_visits(jtree)),
                                  tm.root_child_visits(ttree).numpy())
    np.testing.assert_array_equal(np.asarray(jm.best_move(jtree)), tm.best_move(ttree).numpy())
    assert_trees_equal(jtree, ttree, atol=1e-5, tag="first pass bonus")
    assert (ttree.black_sb != 0).any()


@pytest.mark.parametrize("tt", [False, True])
def test_terminal_tt_score_matches_jax(nets, tt):
    jm, run, tm, sims = _searches(nets, tt)
    js = _near_end(seed=17, moves=18)
    # the root restricted to pass and two board moves: pass ends the game
    pm = _root_mask(js, 2)
    jtree = run(js, jnp.asarray(pm))
    ttree = tm.run(tm.init_tree(jax_to_torch(js), prior_mask=torch.from_numpy(pm)), sims)
    np.testing.assert_array_equal(np.asarray(jm.root_child_visits(jtree)),
                                  tm.root_child_visits(ttree).numpy())
    np.testing.assert_array_equal(np.asarray(jm.best_move(jtree)), tm.best_move(ttree).numpy())
    assert bool(ttree.terminal[:, 1:].any())
