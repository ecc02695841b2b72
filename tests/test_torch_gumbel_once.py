"""One Gumbel draw a search (SearchConfig.gumbel_per_selection=False)
against the JAX package, and the port's A/B harness:

- a 5x5 Gumbel search (B=4, f32) with the one draw injected into both
  packages' ``_sample_gumbel`` (tests/torch_draws.py) gives the JAX
  package's tree, root visits, best move and Gumbel move; the port keeps
  the draw on the tree and reads it at every selection. Both searches
  evaluate with one deterministic function written in each framework
  (fixed priors over the legal moves, a value from the stone balance):
  the JAX search's compile with a net would take most of a minute;
- ``python -m sayuri_tpu_torch.tools.ab_match --cpu`` (2 games, 4
  playouts, per-selection draws against one draw a search) prints one
  JSON line with the keys of the JAX tool's line."""

import ast
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts import core as JC
from sayuri_tpu.mcts import gumbel as JG
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts import core as TC
from sayuri_tpu_torch.mcts import gumbel as TG
from sayuri_tpu_torch.tools import ab_match
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import assert_trees_equal, install_one_draw, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
N, B, SIMS = 5, 4, 24
CFG = dict(max_nodes=SIMS + 4, max_depth=12, gumbel=True, gumbel_considered_moves=8,
           gumbel_per_selection=False)


def evaluators(jenv, env):
    """(JAX eval_fn, port eval_fn) of one deterministic function: priors
    proportional to a fixed table on the legal moves, black's value 0.5 +
    0.01 x (black stones - white stones), that balance as the score."""
    w = np.random.RandomState(0).uniform(0.1, 1.0, N * N + 1).astype(np.float32)

    def j_eval(states, ctx=None):
        legal = jax.vmap(jenv.legal_action_mask)(states)
        p = jnp.where(legal, jnp.asarray(w), 0.0)
        d = jnp.sum(states.stones == 1, (1, 2)) - jnp.sum(states.stones == 2, (1, 2))
        z = jnp.zeros(d.shape)
        return JC.NetEvals(priors=p / jnp.sum(p, -1, keepdims=True), black_wl=0.5 + 0.01 * d,
                           draw=z, black_score=d * 1.0,
                           black_ownership=jnp.zeros((d.shape[0], N * N)))

    def t_eval(states, ctx=None):
        legal = env.legal_action_mask(states)
        p = torch.where(legal, torch.from_numpy(w), 0.0)
        d = (states.stones == 1).sum((1, 2)) - (states.stones == 2).sum((1, 2))
        z = torch.zeros(d.shape)
        return TC.NetEvals(priors=p / p.sum(-1, keepdim=True), black_wl=0.5 + 0.01 * d,
                           draw=z, black_score=d * 1.0,
                           black_ownership=torch.zeros((d.shape[0], N * N)))

    return j_eval, t_eval


@pytest.fixture(scope="module")
def trees():
    jenv, js, _ = random_jax_states(n=N, b=B, moves=4, seed=5, pass_prob=0.0)
    env = GoEnv(n=N)
    j_eval, t_eval = evaluators(jenv, env)
    jm = JC.MCTS(jenv, j_eval, JC.SearchConfig(**CFG))
    tm = TC.MCTS(env, t_eval, TC.SearchConfig(**CFG))
    table = np.random.RandomState(3).gumbel(size=(B, N * N + 1)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        install_one_draw(mp, table)
        jtree = jax.jit(lambda s: jm.run(jm.init_tree(s, jax.random.PRNGKey(0)), SIMS))(js)
        tree = tm.run(tm.init_tree(jax_to_torch(js)), SIMS)
    return jm, jtree, tm, tree, table


def test_one_draw_search_matches_jax(trees):
    jm, jtree, tm, tree, table = trees
    assert_trees_equal(jtree, tree, 1e-5, "one-draw gumbel search")
    np.testing.assert_array_equal(np.asarray(jm.root_child_visits(jtree)),
                                  tm.root_child_visits(tree).numpy())
    np.testing.assert_array_equal(np.asarray(jm.best_move(jtree)), tm.best_move(tree).numpy())
    allow = np.array([True, False, True, False])
    np.testing.assert_array_equal(np.asarray(JG.gumbel_move(jm, jtree, jnp.asarray(allow))),
                                  TG.gumbel_move(tm, tree, torch.from_numpy(allow)).numpy())


def test_the_draw_is_kept_on_the_tree(trees):
    _, jtree, tm, tree, table = trees
    legal = tree.prior[:, 0] > 0
    np.testing.assert_array_equal(tree.root_gumbel.numpy(),
                                  np.where(legal.numpy(), table, -np.inf))
    np.testing.assert_array_equal(np.asarray(jtree.root_gumbel), tree.root_gumbel.numpy())
    for sim_idx in (0, 5, None):
        assert TG._selection_gumbel(tm, tree, sim_idx) is tree.root_gumbel
    # drawn from the search's generator: the same seed gives the same draw
    env = GoEnv(n=N)
    m = TC.MCTS(env, tm.eval_fn, TC.SearchConfig(**CFG))
    s = env.new_batch(2, device="cpu")
    a, b = (m.init_tree(s, torch.Generator().manual_seed(7)).root_gumbel for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a[:, :-1]).all()
    assert TC.MCTS(env, tm.eval_fn, TC.SearchConfig()).init_tree(s).root_gumbel is None


def _jax_line_keys():
    """The keys of the JSON line that tools/ab_match.py prints (read from
    its source: running it would compile the JAX search)."""
    tree = ast.parse((ROOT / "tools/ab_match.py").read_text())
    dump = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "dumps")
    keys = set()
    for d in ast.walk(dump):
        if isinstance(d, ast.Dict):
            keys |= {k.value for k in d.keys if isinstance(k, ast.Constant)}
    return keys


def test_ab_match_prints_the_jax_line():
    out = io.StringIO()
    with redirect_stdout(out):
        line = ab_match.main(["--games", "2", "--boardsize", "5", "--playouts", "4", "--cpu",
                              "--a", "gumbel_per_selection=true",
                              "--b", "gumbel_per_selection=false"])
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert set(printed) == _jax_line_keys() - {"weights_a", "weights_b"}
    assert printed["games"] == 2
    assert printed["a_wins"] + printed["a_losses"] + printed["draws"] == 2
    assert printed["overrides_b"] == {"gumbel_per_selection": False}
