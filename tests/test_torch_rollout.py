"""The port's rollout ownership (mcts/rollout.py) and weightless evaluator
against the JAX package, exact where no random draw decides: the tactical
masks, the tier a random move is taken from, and the final ownership and
score of the port's playout replayed through JAX vmap(env.step). The two
packages' random streams differ, so sampled moves are never compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game import board as JB
from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.mcts import rollout as JR
from sayuri_tpu.models.evaluator import make_dummy_eval_fn as jax_dummy_eval
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts import rollout as R
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn
from tests.test_seki import board_from_diagram
from tests.test_torch_board import jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MASKS = ("capture", "atari", "escape", "self_atari", "simple_eye")

# the boards of tests/test_rollout.py
DIAGRAMS = [
    "xox..\n.....\n.....\n.....\n.....",
    "xoox.\n.....\n.....\n.....\n.....",
    ".x...\nxo.x.\n.x...\n.....\n.....",
    ".....\n.....\n.....\no....\n.o...",
    "xo.o.\noo.o.\n.....\n.....\n.....",
    ".x...\nxx...\n.....\n.....\n.....",
]


def _compare_masks(jenv, js):
    want = jax.vmap(
        lambda s: JR.tactical_masks(
            s.stones, s.size, jenv.legal_action_mask(s)[: jenv.n ** 2].reshape(
                jenv.n, jenv.n), s.to_move)
    )(js)
    ts = jax_to_torch(js)
    tenv = GoEnv(n=jenv.n)
    legal = tenv.legal_action_mask(ts)[:, :-1].reshape(ts.stones.shape)
    got = R.tactical_masks(ts.stones, ts.size, legal, ts.to_move)
    for k in MASKS:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(), err_msg=k)
    return {k: np.asarray(v) for k, v in want.items()}


def test_tactical_masks_on_the_jax_diagrams():
    jenv = JEnv(n=5)
    boards = jnp.stack([board_from_diagram(d, 5) for d in DIAGRAMS] * 2)
    b = boards.shape[0]
    js = jenv.new_batch(b, komi=5.5).replace(
        stones=boards, to_move=jnp.repeat(jnp.arange(2, dtype=jnp.int32), b // 2))
    want = _compare_masks(jenv, js)
    assert want["capture"][0, 6] and want["self_atari"][4, 2]   # as the JAX tests


@pytest.mark.parametrize("n,moves", [(9, 45), (19, 200)])
def test_tactical_masks_on_random_positions(n, moves):
    jenv, js, _ = random_jax_states(n=n, b=4, moves=moves, seed=30 + n)
    want = _compare_masks(jenv, js)
    for k in ("capture", "atari", "escape", "self_atari"):
        assert want[k].any(), k


def test_random_move_lies_in_the_first_usable_tier():
    """The tiers built from the JAX masks with the port's roll: the move
    the port draws is a member of the first usable one (pass iff none)."""
    jenv, js, _ = random_jax_states(n=9, b=16, moves=60, seed=4)
    tenv = GoEnv(n=9)
    ts = jax_to_torch(js)
    nn = 81
    legal = np.asarray(jax.vmap(jenv.legal_action_mask)(js))[:, :nn]
    m = {k: np.asarray(v) for k, v in jax.vmap(
        lambda s, l: JR.tactical_masks(s.stones, s.size, l.reshape(9, 9), s.to_move)
    )(js, jnp.asarray(legal)).items()}
    no_sa = ~m["self_atari"]
    tiers = np.stack([m["capture"], m["atari"] & no_sa, m["escape"] & no_sa,
                      legal & ~(m["simple_eye"] & ~m["capture"] & ~m["escape"])], 1)
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        roll = torch.rand((16, 3), generator=torch.Generator().set_state(gen.get_state()))
        mv = R.random_move_batch(tenv, ts, gen).numpy()
        usable = tiers.any(-1)
        take = np.concatenate([(roll.numpy() < 0.9) & usable[:, :3], usable[:, 3:]], 1)
        for i in range(16):
            if not take[i].any():
                assert mv[i] == nn
                continue
            assert tiers[i, np.argmax(take[i]), mv[i]], (seed, i)


def test_mc_ownership_replays_through_jax(monkeypatch):
    """The port's playout moves (recorded) replayed through JAX
    vmap(env.step) from the same 5x5 roots give the same ownership and
    score; the playouts run to both passes."""
    jenv, tenv = JEnv(n=5), GoEnv(n=5)
    js = jenv.new_batch(4, komi=5.5)
    moves = []
    real = R.random_move_batch

    def spy(*args):
        mv = real(*args)
        moves.append(mv.numpy().copy())
        return mv

    monkeypatch.setattr(R, "random_move_batch", spy)
    own, score = R.mc_ownership(tenv, jax_to_torch(js), torch.Generator().manual_seed(1),
                                max_moves=80)
    step = jax.jit(jax.vmap(jenv.step))
    for mv in moves:
        js = step(js, jnp.asarray(mv))
    assert bool(js.terminated.all())
    want_own = np.asarray(jax.vmap(lambda s: JB.area_ownership(s.stones, s.size))(js))
    np.testing.assert_array_equal(want_own.reshape(4, -1).astype(np.float32), own.numpy())
    want_score = want_own.reshape(4, -1).sum(-1) - np.asarray(
        jax.vmap(jenv.komi_with_penalty)(js))
    np.testing.assert_array_equal(want_score.astype(np.float32), score.numpy())
    assert (np.abs(own.numpy()).sum(-1) > 5).all()


def test_dummy_eval_and_wrapped_search():
    """The dummy evaluator's priors cover the same legal actions as the
    JAX one's and sum to one; a search with the rollout-wrapped evaluator
    gives root visits = playouts + 1 and rollout ownership in {-1, 0, 1}."""
    jenv, js, _ = random_jax_states(n=5, b=3, moves=6, seed=2)
    tenv = GoEnv(n=5)
    ts = jax_to_torch(js)
    jpri = np.asarray(jax_dummy_eval(jenv)(js).priors)
    ev = make_dummy_eval_fn(tenv)(ts)
    np.testing.assert_array_equal(jpri > 0, ev.priors.numpy() > 0)
    np.testing.assert_allclose(ev.priors.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert torch.equal(ev.priors, make_dummy_eval_fn(tenv)(ts).priors)

    fn = R.wrap_eval_with_rollout(tenv, make_dummy_eval_fn(tenv), max_moves=12)
    mcts = MCTS(tenv, fn, SearchConfig(max_nodes=16, max_depth=8))
    tree = mcts.run(mcts.init_tree(ts), 6)
    assert (tree.visits[:, 0] == 7).all()
    assert tree.root_ownership.abs().max() <= 1.0
    assert set(np.unique(fn(ts).black_ownership.numpy())) <= {-1.0, 0.0, 1.0}
