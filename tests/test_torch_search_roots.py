"""The port's search roots against the JAX package's MCTS on the same
weights (float32, 9x9, B=4, a b2c16 net, symmetry "random", ladder planes
off), with the same draws injected into both (tests/torch_draws.py):

- a Dirichlet root with a prior mask and per-lane use_noise;
- a Gumbel root with per-lane use_gumbel and per-lane playout budgets
  (run(budget): a lane with budget 0 stays a bare root), then the move
  pick, advance_root to the new roots with the superko prior mask (a lane
  whose child was never expanded gets a fresh tree), and more search.

Root and child visits and best moves are equal; every tree array is equal
(integers exactly, floats within 1e-5 + 1e-6 relative), the re-rooted trees
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts import gumbel as JG
from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts import gumbel as TG
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from test_torch_board import jax_to_torch, random_jax_states
from test_torch_network import seeded_variables
from torch_draws import Draws, assert_trees_equal, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B, SIMS = 9, 4, 14
ATOL = 1e-5
# one config for both roots: lanes choose Dirichlet or Gumbel by use_noise
# and use_gumbel (the JAX programs compile once for both tests)
CFG = dict(max_nodes=2 * SIMS + 4, max_depth=12, dirichlet_noise=True, gumbel=True,
           gumbel_considered_moves=4)


@pytest.fixture(scope="module")
def setup():
    net, variables, tnet = seeded_variables(seed=4)
    jenv, js, _ = random_jax_states(n=N, b=B, moves=16, seed=21)
    env = GoEnv(n=N)
    jfn = JEV.make_eval_fn(jenv, net, variables, symmetry="random", ladder_mode="off")
    tfn = make_eval_fn(env, tnet, symmetry="random", ladder_mode="off")
    jm, tm = JMCTS(jenv, jfn, JConfig(**CFG)), MCTS(env, tfn, SearchConfig(**CFG))
    key = jax.random.PRNGKey(0)
    j = dict(
        init=jax.jit(lambda s, un, ug, pm: jm.init_tree(s, key, use_noise=un,
                                                         use_gumbel=ug, prior_mask=pm)),
        run=jax.jit(lambda t, budget: jm.run(t, SIMS, budget=budget)),
        advance=jax.jit(lambda t, a, s, un, ug, pm: jm.advance_root(
            t, a, s, key, use_noise=un, use_gumbel=ug, prior_mask=pm)),
    )
    draws = Draws(moves=40, sims=SIMS, b=B, a=N * N + 1, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        draws.install(mp)
        yield jenv, js, env, jax_to_torch(js), jm, tm, j


def _prior_mask(seed):
    rng = np.random.RandomState(seed)
    m = rng.rand(B, N * N + 1) < 0.7
    m[:, -1] = True
    return m


def _lanes(*xs):
    return [(jnp.asarray(x), torch.from_numpy(np.asarray(x))) for x in xs]


def test_dirichlet_root_with_prior_mask(setup):
    jenv, js, env, ts, jm, tm, j = setup
    (jun, tun), (jug, tug), (jpm, tpm), (jb, tb) = _lanes(
        np.array([True, False, True, False]), np.zeros(B, bool), _prior_mask(1),
        np.full(B, SIMS, np.int32))
    jtree = j["run"](j["init"](js, jun, jug, jpm), jb)
    tree = tm.run(tm.init_tree(ts, use_noise=tun, use_gumbel=tug, prior_mask=tpm),
                  SIMS, budget=tb)
    assert_trees_equal(jtree, tree, ATOL, "dirichlet")
    np.testing.assert_array_equal(np.asarray(jm.best_move(jtree)),
                                  tm.best_move(tree).numpy())
    assert (tree.prior[:, 0][~tpm] == 0).all()
    assert (tree.visits[:, 0] == SIMS + 1).all()


def test_gumbel_budgets_and_advance_root(setup):
    jenv, js, env, ts, jm, tm, j = setup
    use_g = np.array([True, True, False, True])
    (jun, tun), (jug, tug), (jug2, tug2), (jb, tb), (jb2, tb2), (jal, tal) = _lanes(
        np.array([False, False, True, False]), use_g,
        np.array([True, False, True, True]),
        np.array([SIMS, 6, 10, 0], np.int32), np.array([SIMS, 9, 3, SIMS], np.int32),
        np.array([True, False, True, True]))
    ones = np.ones((B, N * N + 1), bool)
    jtree = j["run"](j["init"](js, jun, jug, jnp.asarray(ones)), jb)
    tree = tm.run(tm.init_tree(ts, use_noise=tun, use_gumbel=tug,
                               prior_mask=torch.from_numpy(ones)), SIMS, budget=tb)
    assert_trees_equal(jtree, tree, ATOL, "budgets")
    assert tree.visits[:, 0].tolist() == [SIMS + 1, 7, 11, 1]

    jacts = jnp.where(jug, JG.gumbel_move(jm, jtree, jal), jm.best_move(jtree, allow_pass=jal))
    acts = torch.where(tug, TG.gumbel_move(tm, tree, tal), tm.best_move(tree, allow_pass=tal))
    np.testing.assert_array_equal(np.asarray(jacts), acts.numpy())

    jnew, _ = jenv.step_batch_with_analysis(js, jacts)
    jsuperko = jax.jit(jax.vmap(jenv.superko_action_mask))(jnew)
    new_states, _ = env.step_batch_with_analysis(ts, acts)
    superko = env.superko_action_mask(new_states)
    np.testing.assert_array_equal(np.asarray(jsuperko), superko.numpy())
    jtree2, jreused = j["advance"](jtree, jacts, jnew, jun, jug2, ~jsuperko)
    tree2, reused = tm.advance_root(tree, acts, new_states, use_noise=tun,
                                    use_gumbel=tug2, prior_mask=~superko)
    np.testing.assert_array_equal(np.asarray(jreused), reused.numpy())
    assert reused.tolist()[3] is False and reused.any()
    assert_trees_equal(jtree2, tree2, ATOL, "advance_root")

    jtree3 = j["run"](jtree2, jb2)
    tree3 = tm.run(tree2, SIMS, budget=tb2)
    assert_trees_equal(jtree3, tree3, ATOL, "after advance_root")
    np.testing.assert_array_equal(np.asarray(jm.root_child_visits(jtree3)),
                                  tm.root_child_visits(tree3).numpy())
