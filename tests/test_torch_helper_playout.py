"""The port's territory helper playout (SelfplayActor.playout_step and
territory_playout) against the JAX package's, from 5x5 midgame positions
(B=2: an area lane and a territory lane, a b2c8 net in float32, the same
draws injected into both searches): the GoState after each fast
no-exploring move and the helper ownership are equal. The territory lane
switches to area scoring with the score-preserving komi offset and plays
on; the area lane stays frozen and its helper is its own score area."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu.selfplay import actor as JA
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from sayuri_tpu_torch.selfplay import actor as TA
from test_torch_board import assert_states_equal, jax_to_torch, random_jax_states
from test_torch_network import seeded_variables
from test_torch_selfplay import SEARCH, SELFPLAY
from torch_draws import Draws, one_torch_thread  # noqa: F401 (fixture)

N, B, STEPS = 5, 2, 3
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def actors():
    net, variables, tnet = seeded_variables(n=N, channels=8, seed=5)
    jenv, js, _ = random_jax_states(n=N, b=B, moves=7, seed=4, pass_prob=0.0)
    js = js.replace(rule=jnp.asarray(np.array([AREA_RULE, TERRITORY_RULE], np.int32)),
                    komi=jnp.asarray(np.array([0.5, 6.5], np.float32)))
    env = GoEnv(n=N)
    jm = JMCTS(jenv, JEV.make_eval_fn(jenv, net, variables, symmetry="random"),
               JConfig(**SEARCH))
    tm = MCTS(env, make_eval_fn(env, tnet, symmetry="random"), SearchConfig(**SEARCH))
    draws = Draws(moves=20, sims=SELFPLAY["playouts"], b=B, a=N * N + 1, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        draws.install(mp)
        yield (JA.SelfplayActor(jenv, jm, JA.SelfplayConfig(**SELFPLAY)), js,
               TA.SelfplayActor(env, tm, TA.SelfplayConfig(**SELFPLAY)), jax_to_torch(js))


def test_playout_steps_match_jax(actors):
    jactor, js, tactor, ts = actors
    gen = torch.Generator().manual_seed(0)
    for t in range(STEPS):
        js = jactor._playout_step(js, jax.random.PRNGKey(t))
        ts = tactor.playout_step(ts, gen)
        assert_states_equal(js, ts, f"step {t}")


def test_territory_playout_matches_jax(actors):
    """Both games ended by two passes: the territory lane resumes, the area
    lane stays frozen."""
    jactor, js, tactor, ts = actors
    ended = np.ones(B, bool), np.full(B, 2, np.int32)
    js = js.replace(terminated=jnp.asarray(ended[0]), pass_count=jnp.asarray(ended[1]))
    ts = ts.replace(terminated=torch.from_numpy(ended[0]),
                    pass_count=torch.from_numpy(ended[1]))
    want = jactor.territory_playout(js, jax.random.PRNGKey(1), max_steps=STEPS)
    got = tactor.territory_playout(ts, torch.Generator().manual_seed(1), max_steps=STEPS)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert 0 < tactor.last_helper_steps <= STEPS
    # the frozen area lane's helper is its own score area
    np.testing.assert_array_equal(got[0].numpy(),
                                  tactor.env.ownership_with_helper(ts, got)[0].numpy())
