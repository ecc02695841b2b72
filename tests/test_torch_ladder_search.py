"""Ladder planes inside the evaluator and the search, against the JAX
package in float32 at 9x9: ladder_mode "full" NetEvals within 1e-5, and a
search from midgame roots with root ladder planes (noise off, random
symmetry drawn from the position hash) with equal root visit counts and
best moves."""

import jax
import numpy as np

from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from test_torch_board import jax_to_torch, random_jax_states
from test_torch_ladder_planes import check_evaluator_with_ladders
from test_torch_network import seeded_variables

PLAYOUTS = 16


def test_evaluator_full_ladders_matches_jax():
    check_evaluator_with_ladders("full")


def test_search_with_root_ladders_matches_jax():
    """9x9 midgame roots with ladders, the root planes computed once per
    search and read by every leaf (ladder_mode "root"): root visit counts
    and best moves equal the JAX MCTS."""
    from sayuri_tpu.game import ladder as JL
    from sayuri_tpu_torch.game.ladder import ladder_planes_batch

    net, variables, tnet = seeded_variables(seed=4)
    jenv, js, _ = random_jax_states(n=9, b=2, moves=36, seed=13)
    jfn = JEV.make_eval_fn(jenv, net, variables, symmetry="random",
                           ladder_mode="root")
    jm = JMCTS(jenv, jfn, JConfig(max_nodes=PLAYOUTS + 8, max_depth=16))

    @jax.jit
    def jsearch(states):
        ctx = {"ladders": JL.ladder_planes_batch(states.stones, states.size,
                                                 states.ko)}
        tree = jm.init_tree(states, jax.random.PRNGKey(0), ctx=ctx)
        tree = jm.run(tree, PLAYOUTS, ctx=ctx)
        return jm.root_child_visits(tree), jm.best_move(tree), ctx["ladders"]

    j_visits, j_best, j_ladders = jsearch(js)

    env = GoEnv(n=9)
    tm = MCTS(env, make_eval_fn(env, tnet, symmetry="random", ladder_mode="root"),
              SearchConfig(max_nodes=PLAYOUTS + 8, max_depth=16))
    ts = jax_to_torch(js)
    ctx = {"ladders": ladder_planes_batch(ts.stones, ts.size, ts.ko)}
    assert ctx["ladders"].sum() > 0
    np.testing.assert_array_equal(np.asarray(j_ladders), ctx["ladders"].numpy())
    tree = tm.run(tm.init_tree(ts, ctx=ctx), PLAYOUTS, ctx=ctx)
    assert (tree.visits[:, 0] == PLAYOUTS + 1).all()
    np.testing.assert_array_equal(np.asarray(j_visits),
                                  tm.root_child_visits(tree).numpy())
    np.testing.assert_array_equal(np.asarray(j_best), tm.best_move(tree).numpy())
