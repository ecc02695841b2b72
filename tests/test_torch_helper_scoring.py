"""The port's territory-helper scoring (game/analysis.py remove_dead_stones
and score_area_ownership_territory, GoEnv.final_score_with_helper and
ownership_with_helper) against the JAX package, on one 9x9 batch: random
legal games, the pass-dead goldens and the stress boards of
game/positions.py, each with a random helper map and with the helper that
agrees with the board, under both rules. Every output is an integer map
or an integer sum minus komi: all compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game import analysis as JA
from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu_torch.game import analysis as TGA
from sayuri_tpu_torch.game import board as TB
from sayuri_tpu_torch.game.positions import stress_positions
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.game.types import AREA_RULE, TERRITORY_RULE
from test_torch_analysis import _golden_boards
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 9


@pytest.fixture(scope="module")
def batch():
    """(JAX states, port states, helper [B, n, n] int32) on one batch."""
    _, js, _ = random_jax_states(n=N, b=12, moves=55, seed=5)
    rand = jax_to_torch(js)
    _, goldens = _golden_boards()
    st = stress_positions(N)
    stones = torch.cat([rand.stones] + [s.stones for _, s in goldens] + [st[0]])
    size = torch.cat([rand.size] + [s.size for _, s in goldens] + [st[1]])
    b = stones.shape[0]
    rng = np.random.RandomState(7)
    own = TB.area_ownership(stones, size).to(torch.int32)
    noise = torch.from_numpy(rng.randint(-1, 2, size=(b, N, N)).astype(np.int32))
    # even lanes: a random helper; odd lanes: the board's own area with a
    # few random flips (few strings removed)
    flips = torch.from_numpy(rng.rand(b, N, N) < 0.08)
    helper = torch.where(torch.arange(b)[:, None, None] % 2 == 0, noise,
                         torch.where(flips, -own, own))
    rule = torch.from_numpy(np.where(rng.rand(b) < 0.6, TERRITORY_RULE, AREA_RULE)
                            .astype(np.int32))
    played = torch.from_numpy(rng.randint(0, 40, size=(b, 2)).astype(np.int32))
    komi = torch.from_numpy(rng.choice([0.5, 6.5, 7.5], size=b).astype(np.float32))
    ts = GoEnv(n=N).new_batch(b, device="cpu").replace(
        stones=stones, size=size, rule=rule, played_stones=played, komi=komi)
    jst = JEnv(n=N).new_batch(b).replace(
        stones=jnp.asarray(stones.numpy()), size=jnp.asarray(size.numpy()),
        rule=jnp.asarray(rule.numpy()), played_stones=jnp.asarray(played.numpy()),
        komi=jnp.asarray(komi.numpy()))
    return jst, ts, helper


def test_remove_dead_stones_matches_jax(batch):
    jst, ts, helper = batch
    want = jax.jit(jax.vmap(JA.remove_dead_stones))(jst.stones, jst.size,
                                                    jnp.asarray(helper.numpy()))
    got = TGA.remove_dead_stones(ts.stones, ts.size, helper)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    removed = (ts.stones != got).flatten(1).any(1)
    assert 0 < int(removed.sum()) < removed.numel()


def test_score_area_ownership_territory_matches_jax(batch):
    jst, ts, helper = batch
    want = jax.jit(jax.vmap(JA.score_area_ownership_territory))(
        jst.stones, jst.size, jnp.asarray(helper.numpy()))
    got = TGA.score_area_ownership_territory(ts.stones, ts.size, helper)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_final_score_and_ownership_with_helper_match_jax(batch):
    jst, ts, helper = batch
    jenv, env = JEnv(n=N), GoEnv(n=N)
    jh = jnp.asarray(helper.numpy())
    want_score = jax.jit(jax.vmap(jenv.final_score_with_helper))(jst, jh)
    want_own = jax.jit(jax.vmap(jenv.ownership_with_helper))(jst, jh)
    np.testing.assert_array_equal(np.asarray(want_score),
                                  env.final_score_with_helper(ts, helper).numpy())
    np.testing.assert_array_equal(np.asarray(want_own),
                                  env.ownership_with_helper(ts, helper).numpy())
    # area-rule lanes ignore the helper
    area = ts.rule == AREA_RULE
    np.testing.assert_array_equal(env.final_score_with_helper(ts, helper)[area].numpy(),
                                  env.final_score(ts)[area].numpy())
