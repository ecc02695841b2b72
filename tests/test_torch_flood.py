"""The port's board fixpoints (game/board.py flood / chain_labels, their
_plain versions and ops/flood.py) against the JAX package's B.flood and
B.chain_labels on the CPU, exact. The JAX flood kernels have no interpret
switch, so those JAX functions (the XLA path) are their plain reference.
Also area_score and situation_hash.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game import board as JB
from sayuri_tpu_torch.game import board as TB
from sayuri_tpu_torch.ops import flood as FK
from tests.test_torch_board import random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_over_lead(fn, *arrays):
    """Apply a single-board JAX function over every leading dimension."""
    f = fn
    for _ in range(arrays[0].ndim - 2):
        f = jax.vmap(f)
    return np.asarray(jax.jit(f)(*(jnp.asarray(a) for a in arrays)))


def _masks(n, lead, seed, density):
    rng = np.random.RandomState(seed)
    return rng.rand(*lead, n, n) < density


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_chain_labels_match_jax(n, lead):
    FK.reset_launch_counts()
    for density in (0.3, 0.55, 0.8):
        m = _masks(n, lead, n + int(100 * density), density)
        want = _jax_over_lead(JB.chain_labels, m)
        for fn in (TB.chain_labels, TB.chain_labels_plain, FK.chain_labels):
            got = fn(torch.from_numpy(m))
            assert got.dtype == torch.int64 and got.shape == m.shape
            np.testing.assert_array_equal(want, got.numpy(), err_msg=fn.__name__)
    assert FK.LAUNCHES == {"flood": 0, "chain_labels": 0}


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_flood_matches_jax(n, lead):
    FK.reset_launch_counts()
    for density in (0.4, 0.6):
        allowed = _masks(n, lead, 2 * n, density)
        seed = _masks(n, lead, 3 * n, 0.04)
        want = _jax_over_lead(JB.flood, seed, allowed)
        for fn in (TB.flood, TB.flood_plain, FK.flood):
            got = fn(torch.from_numpy(seed), torch.from_numpy(allowed))
            assert got.dtype == torch.bool and got.shape == allowed.shape
            np.testing.assert_array_equal(want, got.numpy(), err_msg=fn.__name__)
    assert FK.LAUNCHES == {"flood": 0, "chain_labels": 0}


def test_reach_and_fixpoints_on_game_boards():
    """Reach seeds and colour masks of random 19x19 games, both paths of
    reach() (dispatching and plain)."""
    _, js, _ = random_jax_states(n=19, b=3, moves=120, seed=7)
    stones = np.asarray(js.stones)
    empty, black = stones == 0, stones == 1
    want = _jax_over_lead(JB.reach, empty, black)
    for plain in (False, True):
        got = TB.reach(torch.from_numpy(empty), torch.from_numpy(black), plain)
        np.testing.assert_array_equal(want, got.numpy())
    for c in (0, 1, 2):
        m = stones == c
        np.testing.assert_array_equal(_jax_over_lead(JB.chain_labels, m),
                                      TB.chain_labels(torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("n", [9, 19])
def test_area_score_and_situation_hash_match_jax(n):
    _, js, _ = random_jax_states(n=n, b=4, moves=3 * n, seed=n + 1)
    ts = torch.from_numpy(np.array(js.stones))
    size = torch.from_numpy(np.array(js.size))
    komi = np.asarray([7.5, 0.5, -3.0, 6.0], np.float32)
    want = np.asarray(jax.vmap(JB.area_score)(js.stones, js.size, jnp.asarray(komi)))
    got = TB.area_score(ts, size, torch.from_numpy(komi))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    for tm in (np.array(js.to_move), np.asarray([0, 1, 1, 0], np.int32)):
        want = np.asarray(jax.vmap(lambda s, t: JB.situation_hash(s, t, n))(
            js.stones, jnp.asarray(tm)))
        got = TB.situation_hash(ts, torch.from_numpy(tm))
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


def test_wrappers_reject_unsupported_input():
    """Only CPU (plain) and CUDA (kernel) tensors are accepted; the CUDA
    path checks the type before it launches."""
    meta = torch.zeros((2, 9, 9), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FK.chain_labels(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        FK.flood(meta, meta)
    with pytest.raises(TypeError, match="stone_mask"):
        FK._check_boards("stone_mask", torch.zeros((2, 9, 9), dtype=torch.int8))
    with pytest.raises(ValueError, match="exceeds"):
        FK._check_boards("allowed", torch.zeros((1, 21, 21), dtype=torch.bool))
