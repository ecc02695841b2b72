"""The port's whole slice (init_tree -> run -> best_move with the fused
step+analysis path and the network evaluator) against the JAX package's
MCTS on the same weights, in float32: 9x9, B=2, 16 playouts, ladder planes
off, symmetry "random". Root visit counts and best moves are equal."""

import jax
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from test_torch_board import jax_to_torch, random_jax_states
from test_torch_network import seeded_variables
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

PLAYOUTS = 16


def test_search_matches_jax_mcts():
    net, variables, tnet = seeded_variables(seed=2)
    jenv, js, _ = random_jax_states(n=9, b=2, moves=12, seed=11)
    jfn = JEV.make_eval_fn(jenv, net, variables, symmetry="random",
                           ladder_mode="off")
    jm = JMCTS(jenv, jfn, JConfig(max_nodes=PLAYOUTS + 8, max_depth=16))

    @jax.jit
    def jsearch(states):
        tree = jm.init_tree(states, jax.random.PRNGKey(0))
        tree = jm.run(tree, PLAYOUTS)
        return (jm.root_child_visits(tree), jm.best_move(tree),
                tree.visits[:, 0], tree.stats[:, 0])

    j_visits, j_best, j_root_n, j_root_stats = jsearch(js)

    env = GoEnv(n=9)
    tm = MCTS(env, make_eval_fn(env, tnet, symmetry="random", ladder_mode="off"),
              SearchConfig(max_nodes=PLAYOUTS + 8, max_depth=16))
    tree = tm.run(tm.init_tree(jax_to_torch(js)), PLAYOUTS)

    np.testing.assert_array_equal(np.asarray(j_root_n), tree.visits[:, 0].numpy())
    assert (tree.visits[:, 0] == PLAYOUTS + 1).all()
    np.testing.assert_array_equal(np.asarray(j_visits),
                                  tm.root_child_visits(tree).numpy())
    np.testing.assert_array_equal(np.asarray(j_best), tm.best_move(tree).numpy())
    # accumulated root statistics: same sums of the same evaluations
    np.testing.assert_allclose(np.asarray(j_root_stats)[:, :4],
                               tree.stats[:, 0, :4].numpy(), atol=1e-4, rtol=0)


def test_terminal_root_and_pass_bookkeeping():
    """Two passes end the game inside the tree: terminal leaves are valued
    by the score-area pass and a terminated root only re-visits itself."""
    env = GoEnv(n=5)
    states = env.new_batch(2, komi=0.5, device="cpu")
    states = env.step(states, torch.tensor([25, 12], dtype=torch.int32))
    states = env.step(states, torch.tensor([25, 25], dtype=torch.int32))
    assert states.terminated.tolist() == [True, False]
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    net = SayuriNet(NetConfig(boardsize=5, residual_channels=8,
                              stack=("ResidualBlock",))).init_random(3).eval()
    m = MCTS(env, make_eval_fn(env, net, symmetry="random", ladder_mode="off"),
             SearchConfig(max_nodes=24, max_depth=8))
    tree = m.run(m.init_tree(states), 12)
    assert tree.visits[:, 0].tolist() == [13, 13]
    assert m.root_child_visits(tree)[0].sum() == 0        # terminal root
    assert m.root_child_visits(tree)[1].sum() == 12
    assert int(tree.next_free[0]) == 1
