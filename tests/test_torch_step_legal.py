"""The port's light env step (ops/analysis.py step_and_legal and
GoEnv.step_batch_light) and the env-steps bench loop against the JAX
package on numpy-seeded games, exact.

The plain twin is held against the Pallas ``_step_legal_kernel`` in
interpret mode (the way tests/test_pallas_kernels.py runs it on the CPU),
and ``step_batch_light`` against the JAX CPU branch (vmap(step) + legal
mask). The kernel branch returns the child's legality unmasked, the CPU
branch all False on terminated lanes, so legality is compared on the lanes
that are live after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.ops import analysis as AK
from sayuri_tpu_torch import bench as TBench
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.ops import analysis as TA
from tests.test_torch_board import assert_states_equal, jax_to_torch
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEP_KEYS = ("new_stones", "n_captured", "new_ko", "new_hash", "legal")


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(AK, "INTERPRET", True)


def _pick(legal, rng, pass_prob):
    """One move per lane: a random legal board move, or pass."""
    nn = legal.shape[1]
    return np.array([
        rng.choice(np.nonzero(l)[0]) if l.any() and rng.rand() > pass_prob else nn
        for l in legal
    ], np.int32)


def test_plain_twin_matches_pallas_kernel_interpret(interpret_mode):
    """B=4 7x7 lanes over three steps: lane 3 passes every move (a game
    that terminates), lane 1 passes now and then; every output equal."""
    n, b = 7, 4
    jenv = JEnv(n=n)
    js = jenv.new_batch(b, komi=7.5)
    rng = np.random.RandomState(5)
    legal_fn = jax.jit(jax.vmap(jenv.legal_action_mask))
    step = jax.jit(jax.vmap(jenv.step))
    for _ in range(12):   # some stones on the board first
        acts = _pick(np.asarray(legal_fn(js))[:, :-1], rng, 0.0)
        js = step(js, jnp.asarray(acts))
    for m in range(3):
        acts = _pick(np.asarray(legal_fn(js))[:, :-1], rng, 0.0)
        acts[3] = n * n
        if m == 1:
            acts[1] = n * n
        ref = AK.step_and_legal_tpu(js.stones, js.size, js.ko, js.to_move,
                                    jnp.asarray(acts))
        ts = jax_to_torch(js)
        args = (ts.stones, ts.size, ts.ko, ts.to_move, torch.from_numpy(acts))
        for fn in (TA.step_and_legal_plain, TA.step_and_legal):
            got = fn(*args)
            for k in STEP_KEYS:
                want = np.asarray(ref[k]).astype(np.int64)
                np.testing.assert_array_equal(
                    want, got[k].numpy().astype(np.int64),
                    err_msg=f"step {m} {fn.__name__} {k}")
        js = step(js, jnp.asarray(acts))
    assert bool(js.terminated[3])


@pytest.mark.parametrize("n,b,moves,pass_prob", [(9, 4, 60, 0.15), (19, 3, 30, 0.05)])
def test_step_batch_light_matches_jax_cpu_branch(n, b, moves, pass_prob):
    """Every GoState field after every move, and the child legality on
    the lanes still live."""
    jenv, tenv = JEnv(n=n), GoEnv(n=n)
    rng = np.random.RandomState(n)
    js = jenv.new_batch(b, komi=7.5)
    ts = tenv.new_batch(b, komi=7.5, device="cpu")
    jlight = jax.jit(jenv.step_batch_light)
    legal = np.asarray(jax.vmap(jenv.legal_action_mask)(js))[:, :-1]
    for m in range(moves):
        acts = _pick(legal, rng, pass_prob)
        js, jlegal = jlight(js, jnp.asarray(acts))
        ts, tlegal = tenv.step_batch_light(ts, torch.from_numpy(acts))
        assert_states_equal(js, ts, f"move {m}")
        live = ~ts.terminated.numpy()
        legal = np.asarray(jlegal)
        np.testing.assert_array_equal(legal[live], tlegal.numpy()[live],
                                      err_msg=f"move {m}")
    if pass_prob > 0.1:
        assert ts.terminated.any()


def _jax_env_steps_loop(env, states, steps, seed):
    """bench.py's env-steps loop body, unjitted over the steps."""
    n = env.n
    batch = states.stones.shape[0]
    states, legal = env.step_batch_light(states, jnp.full((batch,), n * n, jnp.int32))
    legal = legal[:, : n * n]
    lane = jnp.arange(batch, dtype=jnp.uint32)[:, None]
    cell = jnp.arange(n * n, dtype=jnp.uint32)[None, :]
    light = jax.jit(env.step_batch_light)
    for i in range(steps):
        h = (
            lane * jnp.uint32(2654435761)
            ^ (jnp.uint32(i) * jnp.uint32(0x9E3779B9) + jnp.uint32(seed))
            ^ cell * jnp.uint32(2246822519)
        )
        h = h ^ (h >> 15)
        h = h * jnp.uint32(2654435761)
        h = h ^ (h >> 13)
        score = jnp.where(legal, h, jnp.uint32(0))
        acts = jnp.argmax(score, axis=-1).astype(jnp.int32)
        acts = jnp.where(legal.any(axis=-1), acts, n * n)
        states, legal = light(states, acts)
    return states


@pytest.mark.parametrize("seed", [0, 3])
def test_env_steps_loop_matches_jax_bench_loop(seed):
    """The port's env-steps rollout (int64 hash masked to 32 bits) ends in
    the same GoState as the JAX bench's uint32 loop: B=8, 9x9, 24 steps."""
    jenv, tenv = JEnv(n=9), GoEnv(n=9)
    want = _jax_env_steps_loop(jenv, jenv.new_batch(8, komi=7.5), 24, seed)
    got = TBench.env_steps_rollout(tenv, tenv.new_batch(8, komi=7.5, device="cpu"),
                                   24, seed)
    assert_states_equal(want, got, "env-steps loop")
    assert (got.move_count == 25).all()


def test_mul32_is_uint32_multiply():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, size=1000, dtype=np.uint64)
    for c in (2654435761, 2246822519, 0x9E3779B9, 0xFFFFFFFF):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = TBench._mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
