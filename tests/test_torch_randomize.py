"""The port's game randomization (selfplay/randomize.py) against the JAX
package: query parsing, komi quantization, the host-side draws of
`prepare` for the same seed, and, with a one-hot evaluator (the sampling
then has one outcome in both packages: log(1e-25) / temp leaves the other
moves far below any Gumbel noise), the same opening and handicap boards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.mcts.core import NetEvals as JNetEvals
from sayuri_tpu.selfplay import randomize as JR
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import NetEvals
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn
from sayuri_tpu_torch.selfplay import randomize as R
from tests.test_mcts import make_dummy_eval as jax_uniform_eval
from tests.test_torch_board import assert_states_equal
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUERIES = [
    ["bkp:9:7.5:0.8", "bkp:7:6.5:0.2", "bhp:9:4:0.3", "srs:area:territory"],
    ["bkp:9:7:2.0", "bkp:5:7:2.0"],
    ["srs:territory"],
    ["bhp:9:1:0.5", "bhp:9:3:1.0", "bkp 9 0.5 1", "junk", ""],
]

DIST_KW = dict(random_opening_prob=0.6, random_moves_factor=0.1, komi_stddev=1.0,
               komi_big_stddev=4.0, komi_big_stddev_prob=0.3,
               handicap_fair_komi_prob=0.5)


def _jax_key(seed):
    """A raw JAX key whose first word is `seed` (what prepare seeds numpy
    with)."""
    return jnp.asarray([seed, 7], jnp.uint32)


@pytest.mark.parametrize("queries", QUERIES)
def test_parse_queries_matches_jax(queries):
    want = JR.parse_queries(queries, default_size=9, **DIST_KW)
    got = R.parse_queries(queries, default_size=9, **DIST_KW)
    for f in ("board_queries", "handicap_queries", "scoring_set",
              "random_opening_prob", "komi_stddev", "max_boardsize"):
        assert getattr(want, f) == getattr(got, f), f


def test_adjust_komi_matches_jax():
    vals = np.asarray([7.5, 7.1, 7.4, 7.8, -6.6, 0.1, 0.0, -0.25, 0.75, 12.26,
                       -3.74], np.float32)
    np.testing.assert_array_equal(np.asarray(JR.adjust_komi(jnp.asarray(vals))),
                                  R.adjust_komi(torch.from_numpy(vals)).numpy())


def _dist(mod):
    return mod.parse_queries(["bkp:9:7.5:0.5", "bkp:7:6.5:0.5", "bhp:9:4:0.6",
                              "bhp:7:3:0.5", "srs:area:territory"], **DIST_KW)


@pytest.mark.parametrize("seed", [0, 11])
def test_prepare_host_draws_match_jax(seed):
    """Sizes, komi, rules, handicaps and opening lengths (move counts) for
    the same seed; the sampled moves themselves differ."""
    jenv, tenv = JEnv(n=9), GoEnv(n=9)
    want = JR.GameRandomizer(jenv, _dist(JR), jax_uniform_eval(jenv)).prepare(
        12, _jax_key(seed))
    got = R.GameRandomizer(tenv, _dist(R), make_dummy_eval_fn(tenv)).prepare(
        12, seed, device="cpu")
    for f in ("size", "komi", "rule", "handicap", "move_count", "to_move"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert (got.handicap > 0).any() and (got.move_count > 0).any()
    legal = tenv.legal_action_mask(got)
    assert legal[:, :-1].any(-1).all()


def _onehot_key(n):
    """A fixed scrambled order of the board points."""
    return (np.arange(n * n) * 7919) % (n * n)


def _jax_onehot_eval(env):
    nn = env.n * env.n
    key = jnp.asarray(_onehot_key(env.n))

    def eval_fn(states, ctx=None):
        b = states.stones.shape[0]
        legal = jax.vmap(env.legal_action_mask)(states)[:, :nn]
        pick = jnp.argmax(jnp.where(legal, key, -1), -1)
        z = jnp.zeros((b,))
        return JNetEvals(priors=jax.nn.one_hot(pick, nn + 1), black_wl=z + 0.5,
                         draw=z, black_score=z, black_ownership=jnp.zeros((b, nn)))

    return eval_fn


def _torch_onehot_eval(env):
    nn = env.n * env.n
    key = torch.from_numpy(_onehot_key(env.n))

    def eval_fn(states, ctx=None):
        b = states.stones.shape[0]
        legal = env.legal_action_mask(states)[:, :nn]
        pick = torch.where(legal, key, -1).argmax(-1)
        z = torch.zeros((b,))
        return NetEvals(priors=torch.nn.functional.one_hot(pick, nn + 1).float(),
                        black_wl=z + 0.5, draw=z, black_score=z,
                        black_ownership=torch.zeros((b, nn)))

    return eval_fn


@pytest.mark.parametrize("seed", [2, 5])
def test_prepare_onehot_boards_match_jax(seed):
    """With a one-hot evaluator both packages play the same handicap
    stones and opening moves: every GoState field equal."""
    jenv, tenv = JEnv(n=9), GoEnv(n=9)
    want = JR.GameRandomizer(jenv, _dist(JR), _jax_onehot_eval(jenv)).prepare(
        10, _jax_key(seed))
    got = R.GameRandomizer(tenv, _dist(R), _torch_onehot_eval(tenv)).prepare(
        10, seed, device="cpu")
    assert_states_equal(want, got, f"seed {seed}")
    assert int(got.stones.ne(0).sum()) > 20
