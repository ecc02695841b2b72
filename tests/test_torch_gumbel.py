"""The port's Gumbel root (mcts/gumbel.py) against the JAX package's:
the Sequential-Halving walk equal; then, on trees that both searches built
from the same weights (float32, 9x9, B=4, a b2c16 net, Gumbel roots) with
the same draws injected (tests/torch_draws.py), root_scores,
completed_q_policy and gumbel_move agree: floats within 1e-5, -inf where
the JAX scores are -inf, equal moves. The port's own selection noise:
fresh every selection, reproducible from the tree's generator."""

from types import SimpleNamespace

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

# the port's own selection noise, kept before the fixtures patch it
SELECTION_GUMBEL = TG._selection_gumbel

N, B, SIMS = 9, 4, 20
ATOL = 1e-5


@pytest.mark.parametrize("considered,prom,threshold",
                         [(16, 1, 400), (4, 1, 50), (8, 3, 200), (1, 1, 7), (10, 2, 64)])
def test_sh_sequence_matches_jax(considered, prom, threshold):
    want = JG.sh_sequence(considered, prom, threshold)
    got = TG.sh_sequence(considered, prom, threshold)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g)


@pytest.fixture(scope="module")
def trees():
    net, variables, tnet = seeded_variables(seed=6)
    jenv, js, _ = random_jax_states(n=N, b=B, moves=24, seed=8)
    env = GoEnv(n=N)
    cfg = dict(max_nodes=SIMS + 4, max_depth=12, gumbel=True, gumbel_considered_moves=8)
    jm = JMCTS(jenv, JEV.make_eval_fn(jenv, net, variables, symmetry="random",
                                      ladder_mode="off"), JConfig(**cfg))
    tm = MCTS(env, make_eval_fn(env, tnet, symmetry="random", ladder_mode="off"),
              SearchConfig(**cfg))
    draws = Draws(moves=40, sims=SIMS, b=B, a=N * N + 1, seed=9)
    with pytest.MonkeyPatch.context() as mp:
        draws.install(mp)
        jtree = jax.jit(lambda s: jm.run(jm.init_tree(s, jax.random.PRNGKey(0)), SIMS))(js)
        tree = tm.run(tm.init_tree(jax_to_torch(js)), SIMS)
        yield jm, jtree, tm, tree


def _close(want, got):
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)


def test_trees_match(trees):
    jm, jtree, tm, tree = trees
    assert_trees_equal(jtree, tree, ATOL, "gumbel search")
    np.testing.assert_array_equal(np.asarray(jm.root_child_visits(jtree)),
                                  tm.root_child_visits(tree).numpy())


@pytest.mark.parametrize("sim_idx", [0, 7, None])
def test_root_scores_match(trees, sim_idx):
    jm, jtree, tm, tree = trees
    want = JG.root_scores(jm, jtree, sim_idx=sim_idx)
    got = TG.root_scores(tm, tree, sim_idx=sim_idx)
    _close(want, got)
    assert np.isfinite(np.asarray(want)).any()


def test_completed_q_policy_matches(trees):
    jm, jtree, tm, tree = trees
    want = JG.completed_q_policy(jm, jtree)
    got = TG.completed_q_policy(tm, tree)
    _close(want, got)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("allow", [[True] * B, [False] * B, [True, False, False, True]])
def test_gumbel_move_and_best_move_match(trees, allow):
    jm, jtree, tm, tree = trees
    allow = np.asarray(allow)
    np.testing.assert_array_equal(np.asarray(JG.gumbel_move(jm, jtree, jnp.asarray(allow))),
                                  TG.gumbel_move(tm, tree, torch.from_numpy(allow)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jm.best_move(jtree, allow_pass=jnp.asarray(allow))),
        tm.best_move(tree, allow_pass=torch.from_numpy(allow)).numpy())
    color = jtree.states.to_move[:, 0]
    _close(jm.root_child_q(jtree, color),
           tm.root_child_q(tree, torch.tensor(np.array(color))))


def test_selection_noise_is_fresh_per_selection():
    """The port draws new standard Gumbel noise at every root selection and
    at the move pick, from the tree's generator alone (no per-search draw
    is kept): the same seed gives the same draws, consecutive draws differ,
    and a large draw has the Gumbel mean (Euler's constant) within 0.01."""
    def draws(seed, b=B, a=N * N + 1, tags=(0, 1, None)):
        tree = SimpleNamespace(prior=torch.zeros(b, 2, a),
                               gen=torch.Generator().manual_seed(seed))
        mcts = SimpleNamespace(cfg=SearchConfig())   # gumbel_per_selection on
        return [SELECTION_GUMBEL(mcts, tree, t) for t in tags]

    first, again = draws(5), draws(5)
    for x, y in zip(first, again):
        assert x.shape == (B, N * N + 1) and bool(torch.isfinite(x).all())
        assert torch.equal(x, y)
    assert not torch.equal(first[0], first[1]) and not torch.equal(first[1], first[2])
    big = draws(6, b=1024, a=256, tags=(0,))[0]
    assert abs(float(big.mean()) - 0.5772157) < 0.01
