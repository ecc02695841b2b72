"""The PyTorch port's rules engine (sayuri_tpu_torch.game) against the JAX
package on identical numpy-seeded games, exact.

Also holds the helpers the other test_torch_* files share: JAX GoState ->
port GoState conversion and random legal JAX games.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sayuri_tpu.game import board as JB
from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu_torch.game import board as TB
from sayuri_tpu_torch.game.state import GoEnv, GoState


def jax_to_torch(states) -> GoState:
    """Batched JAX GoState -> port GoState (uint32 hashes -> int64)."""
    fields = {}
    for name in GoState.__dataclass_fields__:
        a = np.asarray(getattr(states, name))
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        fields[name] = torch.from_numpy(a.copy())
    return GoState(**fields)


def random_jax_states(n=9, b=4, moves=20, seed=0, pass_prob=0.05, komi=7.5):
    """Play `moves` uniformly random legal moves (numpy rng) on a JAX
    batch; returns (jax env, jax states, list of per-move actions)."""
    env = JEnv(n=n)
    rng = np.random.RandomState(seed)
    states = env.new_batch(b, komi=komi)
    step = jax.jit(jax.vmap(env.step))
    legal_fn = jax.jit(jax.vmap(env.legal_action_mask))
    history = []
    for _ in range(moves):
        legal = np.asarray(legal_fn(states))[:, : n * n]
        acts = np.array([
            rng.choice(np.nonzero(l)[0]) if l.any() and rng.rand() > pass_prob
            else n * n
            for l in legal
        ], np.int32)
        states = step(states, jnp.asarray(acts))
        history.append(acts)
    return env, states, history


def assert_states_equal(jax_states, port_states, tag=""):
    ref = jax_to_torch(jax_states)
    for name in GoState.__dataclass_fields__:
        want, got = getattr(ref, name), getattr(port_states, name)
        assert want.shape == got.shape, (tag, name, want.shape, got.shape)
        assert torch.equal(want.to(got.dtype), got), (tag, name)


class TestEnvAgainstJax:
    def test_new_batch_matches(self):
        for n in (5, 9, 19):
            ref = JEnv(n=n).new_batch(3, komi=6.5)
            assert_states_equal(ref, GoEnv(n=n).new_batch(3, komi=6.5), n)

    def test_random_games_step_legal_hash(self):
        """vmap(env.step) and legal_action_mask over random 9x9 games with
        passes, captures and ko: every GoState field after every move."""
        n, b = 9, 4
        jenv = JEnv(n=n)
        tenv = GoEnv(n=n)
        rng = np.random.RandomState(1)
        js = jenv.new_batch(b, komi=7.5)
        ts = tenv.new_batch(b, komi=7.5)
        step = jax.jit(jax.vmap(jenv.step))
        legal_fn = jax.jit(jax.vmap(jenv.legal_action_mask))
        for m in range(70):
            legal = np.asarray(legal_fn(js))
            np.testing.assert_array_equal(
                legal, tenv.legal_action_mask(ts).numpy(), err_msg=f"move {m}"
            )
            acts = np.array([
                rng.choice(np.nonzero(l[:-1])[0])
                if l[:-1].any() and rng.rand() > 0.05 else n * n
                for l in legal
            ], np.int32)
            js = step(js, jnp.asarray(acts))
            ts = tenv.step(ts, torch.from_numpy(acts))
            assert_states_equal(js, ts, f"move {m}")

    def test_step_batch_with_analysis_matches_vmap_step(self):
        """The search's step path (step+analysis twin, then the kernel-output
        merge) against JAX vmap(env.step) on random 9x9 games that pass to
        the end: every GoState field after every move, the freeze of
        finished lanes, and the child's legality from the analysis."""
        n, b = 9, 4
        jenv, tenv = JEnv(n=n), GoEnv(n=n)
        rng = np.random.RandomState(9)
        js = jenv.new_batch(b, komi=7.5)
        ts = tenv.new_batch(b, komi=7.5)
        step = jax.jit(jax.vmap(jenv.step))
        legal_fn = jax.jit(jax.vmap(jenv.legal_action_mask))
        for m in range(40):
            legal = np.asarray(legal_fn(js))
            acts = np.array([
                rng.choice(np.nonzero(l[:-1])[0])
                if l[:-1].any() and rng.rand() > 0.15 else n * n
                for l in legal
            ], np.int32)
            js = step(js, jnp.asarray(acts))
            ts, ana = tenv.step_batch_with_analysis(ts, torch.from_numpy(acts))
            assert_states_equal(js, ts, f"move {m}")
            child_legal = ana["legal"] & ~ts.terminated[:, None]
            np.testing.assert_array_equal(
                np.asarray(legal_fn(js))[:, : n * n], child_legal.numpy(),
                err_msg=f"move {m}",
            )
        assert ts.terminated.any()

    def test_position_hash_matches(self):
        _, states, _ = random_jax_states(n=9, b=4, moves=30, seed=2)
        ref = np.asarray(jax.vmap(lambda s: JB.position_hash(s, 9))(states.stones))
        got = TB.position_hash(torch.from_numpy(np.array(states.stones)))
        np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())
        assert got.max() < 2**32 and got.min() >= 0

    def test_labels_liberties_ownership_match(self):
        _, states, _ = random_jax_states(n=9, b=4, moves=45, seed=3)
        stones = np.array(states.stones)
        ts = torch.from_numpy(stones)
        for c in (1, 2):
            m = stones == c
            jl = np.asarray(jax.vmap(JB.chain_labels)(jnp.asarray(m)))
            tl = TB.chain_labels(torch.from_numpy(m))
            np.testing.assert_array_equal(jl, tl.numpy())
            empty = jnp.asarray(stones == 0)
            jlib = np.asarray(jax.vmap(JB.chain_liberty_map)(
                jnp.asarray(m), jnp.asarray(jl), empty))
            tlib = TB.chain_liberty_map(torch.from_numpy(m), tl,
                                        torch.from_numpy(stones == 0))
            np.testing.assert_array_equal(jlib, tlib.numpy())
        jo = np.asarray(jax.vmap(JB.area_ownership)(states.stones, states.size))
        np.testing.assert_array_equal(jo, TB.area_ownership(ts, 9).numpy())

    def test_komi_penalty_and_wave_match(self):
        jenv, tenv = JEnv(n=9), GoEnv(n=9)
        _, js, _ = random_jax_states(n=9, b=6, moves=7, seed=4)
        js = js.replace(
            komi=jnp.asarray([7.5, 6.5, 0.5, -3.0, 5.0, 7.0], jnp.float32),
            rule=jnp.asarray([0, 1, 0, 1, 0, 0], jnp.int32),
            handicap=jnp.asarray([0, 0, 2, 0, 1, 0], jnp.int32),
            size=jnp.asarray([9, 9, 8, 9, 7, 9], jnp.int32),
        )
        ts = jax_to_torch(js)
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(jenv.komi_with_penalty)(js)),
            tenv.komi_with_penalty(ts).numpy(),
        )
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(jenv.wave)(js)), tenv.wave(ts).numpy()
        )
