"""The evaluator options the GTP engine sets (models/evaluator.py) against
the JAX package's, in float32 at 7x7 with a 2-block x 16-channel net:
symmetry "average", the optimistic policy head, the policy temperature,
the sym_seed of the random symmetry, the pass-suppression factor (0 and
the default) and the side-to-move winrate head; NetEvals within 1e-5. A
search whose root evaluator has its own temperature and head gives the JAX
package's root priors (1e-5), root visits and best moves. The weightless
evaluator's suppress_pass_factor, and its rng_seed, ignored in both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn, suppress_pass
from test_torch_board import jax_to_torch, random_jax_states
from test_torch_network import seeded_variables
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

ATOL = 1e-5
N = 7
pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTIONS = {
    "average": dict(symmetry="average", suppress_pass_factor=0.0),
    "optimistic head": dict(symmetry="random", policy_head="optimistic_prob"),
    "policy temp": dict(symmetry=3, policy_temp=0.5),
    "sym seed": dict(symmetry="random", sym_seed=5),
    "no pass suppression": dict(symmetry=0, suppress_pass_factor=0.0),
    "default pass suppression": dict(symmetry=0),
    "strong pass suppression": dict(symmetry=0, suppress_pass_factor=0.9),
    "stm winrate": dict(symmetry="random", use_stm_winrate=True),
}


@pytest.fixture(scope="module")
def setup():
    net, variables, tnet = seeded_variables(n=N, seed=4)
    jenv, js, _ = random_jax_states(n=N, b=4, moves=10, seed=9, pass_prob=0.0)
    return net, variables, tnet, jenv, js


@pytest.mark.parametrize("name", list(OPTIONS))
def test_netevals_match_jax(setup, name):
    net, variables, tnet, jenv, js = setup
    kw = OPTIONS[name]
    ref = jax.jit(JEV.make_eval_fn(jenv, net, variables, ladder_mode="off", **kw))(js)
    got = make_eval_fn(GoEnv(n=N), tnet, ladder_mode="off", **kw)(jax_to_torch(js))
    for k in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(ref, k)), getattr(got, k).numpy(),
                                   atol=ATOL, rtol=0, err_msg=f"{name}: {k}")
    if name == "strong pass suppression":
        assert (got.priors[:, -1] == 0).all()
    if name == "no pass suppression":
        assert (got.priors[:, -1] > 0).all()


def test_root_evaluator_matches_jax(setup):
    """Leaves with the optimistic head at temperature 1, the root with the
    normal head at 0.7 (the Agent's pairing)."""
    net, variables, tnet, jenv, js = setup
    cfg = dict(max_nodes=24, max_depth=12)
    leaf = dict(symmetry="random", ladder_mode="off", policy_head="optimistic_prob")
    root = dict(symmetry="random", ladder_mode="off", policy_temp=0.7)
    jm = JMCTS(jenv, JEV.make_eval_fn(jenv, net, variables, **leaf), JConfig(**cfg),
               root_eval_fn=JEV.make_eval_fn(jenv, net, variables, **root))

    @jax.jit
    def jsearch(states):
        tree = jm.run(jm.init_tree(states, jax.random.PRNGKey(0)), 16)
        return tree.prior[:, 0], jm.root_child_visits(tree), jm.best_move(tree)

    j_prior, j_visits, j_best = jsearch(js)
    env = GoEnv(n=N)
    tm = MCTS(env, make_eval_fn(env, tnet, **leaf), SearchConfig(**cfg),
              root_eval_fn=make_eval_fn(env, tnet, **root))
    tree = tm.init_tree(jax_to_torch(js))
    np.testing.assert_allclose(np.asarray(j_prior), tree.prior[:, 0].numpy(), atol=ATOL,
                               rtol=0)
    plain = make_eval_fn(env, tnet, **leaf)(jax_to_torch(js)).priors
    assert not torch.allclose(plain, tree.prior[:, 0], atol=1e-3)
    tree = tm.run(tree, 16)
    np.testing.assert_array_equal(np.asarray(j_visits), tm.root_child_visits(tree).numpy())
    np.testing.assert_array_equal(np.asarray(j_best), tm.best_move(tree).numpy())


def test_dummy_eval_suppress_pass_factor():
    env = GoEnv(n=N)
    states = env.new_batch(3, device="cpu")
    states = env.step(states, torch.tensor([10, 24, 49], dtype=torch.int32))
    base = make_dummy_eval_fn(env)(states)
    assert (base.priors[:, -1] > 0).all()
    got = make_dummy_eval_fn(env, suppress_pass_factor=0.5)(states)
    legal = env.legal_action_mask(states)
    torch.testing.assert_close(got.priors, suppress_pass(base.priors, legal, states.size, 0.5))
    # 48 legal board moves of 49 leave pass out; the last lane passed and
    # has 49, so pass is out there too; the priors still sum to 1
    assert (got.priors[:, -1] == 0).all()
    torch.testing.assert_close(got.priors.sum(-1), torch.ones(3))


def test_dummy_eval_rng_seed():
    """rng_seed is accepted and ignored, as by the JAX package's dummy
    evaluator: the noise depends on the position hash alone."""
    env, jenv = GoEnv(n=N), JEnv(n=N)
    states = env.step(env.new_batch(2, device="cpu"), torch.tensor([3, 30], dtype=torch.int32))
    default = make_dummy_eval_fn(env)(states).priors
    for seed in (0, 7):
        assert torch.equal(make_dummy_eval_fn(env, rng_seed=seed)(states).priors, default)
    jstates = jax.tree.map(lambda *x: jnp.stack(x),
                           *(jenv.step(jenv.new_state(), jnp.int32(a)) for a in (3, 30)))
    jdefault = np.asarray(JEV.make_dummy_eval_fn(jenv)(jstates).priors)
    np.testing.assert_array_equal(
        np.asarray(JEV.make_dummy_eval_fn(jenv, rng_seed=7)(jstates).priors), jdefault)
    assert torch.equal(default > 0, torch.from_numpy(jdefault > 0))
    torch.testing.assert_close(default.sum(-1), torch.ones(2))
