"""The port's GoEnv queries against jax.vmap of the JAX methods on
numpy-seeded random games, exact: step, legal_action_mask,
superko_violation / superko_action_mask, final_score, ownership and
penalty_offset_to_area; plus the superko scenario of tests/test_board.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.ops import flood as FK
from tests.test_torch_board import assert_states_equal, jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _varied(js):
    """Mixed rules, handicaps and komi over a batch of 6."""
    return js.replace(
        komi=jnp.asarray([7.5, 6.5, 0.5, -3.0, 5.0, 7.0], jnp.float32),
        rule=jnp.asarray([0, 1, 0, 1, 0, 1], jnp.int32),
        handicap=jnp.asarray([0, 0, 2, 3, 0, 0], jnp.int32),
    )


@pytest.mark.parametrize("n,moves", [(9, 50), (19, 140)])
def test_queries_match_jax(n, moves):
    jenv, tenv = JEnv(n=n), GoEnv(n=n)
    _, js, _ = random_jax_states(n=n, b=6, moves=moves, seed=20 + n, pass_prob=0.1)
    js = _varied(js)
    ts = jax_to_torch(js)
    FK.reset_launch_counts()
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jenv.legal_action_mask)(js)),
        tenv.legal_action_mask(ts).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(jenv.final_score))(js)),
        tenv.final_score(ts).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jenv.ownership)(js)), tenv.ownership(ts).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jenv.penalty_offset_to_area)(js)),
        tenv.penalty_offset_to_area(ts).numpy())
    assert FK.LAUNCHES == {"flood": 0, "chain_labels": 0}


def _no_pass_states(n, b, moves, seed):
    """Random legal games without passes: crowded boards, many captures."""
    env = JEnv(n=n)
    rng = np.random.RandomState(seed)
    states = env.new_batch(b, komi=7.5)
    step = jax.jit(jax.vmap(env.step))
    legal_fn = jax.jit(jax.vmap(env.legal_action_mask))
    for _ in range(moves):
        legal = np.asarray(legal_fn(states))[:, : n * n]
        acts = np.array([rng.choice(np.nonzero(l)[0]) if l.any() else n * n
                         for l in legal], np.int32)
        states = step(states, jnp.asarray(acts))
    return env, states


def _ko_states():
    """The JAX superko scenario (tests/test_board.py) right after black
    takes the ko: the recapture at (1, 1) would repeat a ring position."""
    env = JEnv(n=5)
    js = env.new_batch(1, komi=0.0)
    step = jax.jit(jax.vmap(env.step))
    for mv in (1, 2, 5, 6, 11, 8, 24, 12, 7):
        js = step(js, jnp.asarray([mv], jnp.int32))
    return env, js


def test_superko_mask_and_violation_match_jax():
    """superko_action_mask over every action, and superko_violation of one
    action per lane, on crowded 5x5 games and on a ko position."""
    jenv, js = _no_pass_states(5, 6, 60, seed=3)
    tenv = GoEnv(n=5)
    ts = jax_to_torch(js)
    want = np.asarray(jax.jit(jax.vmap(jenv.superko_action_mask))(js))
    got = tenv.superko_action_mask(ts)
    assert got.shape == (6, 26)
    np.testing.assert_array_equal(want, got.numpy())
    assert want[:, :-1].any(-1).all()
    rng = np.random.RandomState(0)
    acts = rng.randint(0, 26, size=6).astype(np.int32)
    acts[np.argmax(want.any(-1))] = np.argmax(want[np.argmax(want.any(-1))])
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jenv.superko_violation)(js, jnp.asarray(acts))),
        tenv.superko_violation(ts, torch.from_numpy(acts)).numpy())
    jenv, js = _ko_states()
    want = np.asarray(jax.vmap(jenv.superko_action_mask)(js))
    assert want[0, 6]    # the ko recapture, a hit in the hash ring
    np.testing.assert_array_equal(want, tenv.superko_action_mask(jax_to_torch(js)).numpy())


def test_superko_scenario_of_the_jax_tests():
    """tests/test_board.py test_superko_detected, replayed in the port:
    the ko recapture is illegal and a superko violation; after a tenuki
    exchange it is no longer a positional repeat."""
    env = GoEnv(n=5)
    s = env.new_batch(1, komi=0.0, device="cpu")

    def v(y, x):
        return y * 5 + x

    def play(s, mv):
        return env.step(s, torch.tensor([mv], dtype=torch.int32))

    for color, mv in ((0, v(0, 1)), (1, v(0, 2)), (0, v(1, 0)), (1, v(1, 1)),
                      (0, v(2, 1)), (1, v(1, 3)), (0, v(4, 4)), (1, v(2, 2))):
        assert int(s.to_move[0]) == color
        s = play(s, mv)
    s = play(s, v(1, 2))
    assert int(s.ko[0]) == v(1, 1)
    assert not bool(env.legal_action_mask(s)[0, v(1, 1)])
    assert bool(env.superko_violation(s, torch.tensor([v(1, 1)]))[0])
    assert bool(env.superko_action_mask(s)[0, v(1, 1)])
    s = play(play(s, v(4, 0)), v(3, 4))
    assert not bool(env.superko_violation(s, torch.tensor([v(1, 1)]))[0])
    # (occupied own points also read as repeats: the mask is for legal moves)
    assert not bool((env.superko_action_mask(s) & env.legal_action_mask(s)).any())


def test_step_and_queries_along_games():
    """Step, legality and ownership after every move of random 9x9 games
    with passes (the superko ring fills as the games go)."""
    n, b = 9, 4
    jenv, tenv = JEnv(n=n), GoEnv(n=n)
    rng = np.random.RandomState(11)
    js = jenv.new_batch(b, komi=7.5)
    ts = tenv.new_batch(b, komi=7.5, device="cpu")
    step = jax.jit(jax.vmap(jenv.step))
    legal_fn = jax.jit(jax.vmap(jenv.legal_action_mask))
    own_fn = jax.jit(jax.vmap(jenv.ownership))
    for m in range(40):
        legal = np.asarray(legal_fn(js))
        np.testing.assert_array_equal(legal, tenv.legal_action_mask(ts).numpy())
        acts = np.array([rng.choice(np.nonzero(l[:-1])[0])
                         if l[:-1].any() and rng.rand() > 0.1 else n * n
                         for l in legal], np.int32)
        js = step(js, jnp.asarray(acts))
        ts = tenv.step(ts, torch.from_numpy(acts))
        assert_states_equal(js, ts, f"move {m}")
        np.testing.assert_array_equal(np.asarray(own_fn(js)), tenv.ownership(ts).numpy())
