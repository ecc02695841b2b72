"""The port's ``ladder_planes_batch`` (prep, greedy and chase twins on the
CPU) against the JAX front end with its XLA search, and against the
recursive oracle (tests/ladder_oracle.py) on the classic ladder diagrams
of tests/test_ladder_exact.py and on random boards. Planes are 0/1, so
every comparison is exact. Also the evaluator with root ladder planes;
test_torch_ladder_search.py holds the "full" mode and the search."""

import jax
import numpy as np
import pytest
import torch

from sayuri_tpu.game import ladder as JL
from sayuri_tpu_torch.game import ladder as TL
from test_ladder_exact import board_from_diagram, oracle_planes
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@jax.jit
def _jax_planes(stones, size, ko):
    return JL.ladder_planes_batch(stones, size, ko, use_kernel=False)


@pytest.mark.parametrize("n,b,moves", [(9, 6, 45), (19, 3, 160)])
def test_planes_match_jax(n, b, moves):
    _, js, _ = random_jax_states(n=n, b=b, moves=moves, seed=20 + n)
    ts = jax_to_torch(js)
    ref = np.asarray(_jax_planes(js.stones, js.size, js.ko))
    got = TL.ladder_planes_batch(ts.stones, ts.size, ts.ko)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert ref.sum() > 0
    np.testing.assert_array_equal(ref, got.numpy())


def test_planes_match_oracle_on_diagrams():
    """The classic corner ladder (the hunter wins: death, escapable, atari
    and take marks) and the same ladder with a breaker (no marks), each
    also with the colours swapped."""
    base = [
        ".........",
        "...X.....",
        "..XO.....",
        "..X......",
        ".........",
        ".........",
        ".........",
        ".........",
        ".........",
    ]
    works = board_from_diagram(base)
    breaker = works.copy()
    breaker[6, 7] = 2
    boards = np.stack([works, breaker, (3 - works) % 3, (3 - breaker) % 3])
    got = TL.ladder_planes_batch(
        torch.from_numpy(boards.astype(np.int8)),
        torch.full((4,), 9, dtype=torch.int32),
        torch.full((4,), -1, dtype=torch.int32),
    ).numpy()
    for i in range(4):
        want = oracle_planes(boards[i].reshape(-1), 9, -1)
        np.testing.assert_array_equal(got[i], want, err_msg=f"board {i}")
    assert got[0][2, 3, 1] == 1.0 and got[0][2, 4, 2] == 1.0
    assert got[1].sum() == 0.0
    single = TL.ladder_planes(torch.from_numpy(works.astype(np.int8)), 9)
    np.testing.assert_array_equal(single.numpy(), got[0])


def test_planes_match_oracle_on_random_boards():
    _, js, _ = random_jax_states(n=9, b=6, moves=34, seed=7)
    ts = jax_to_torch(js)
    got = TL.ladder_planes_batch(ts.stones, ts.size, ts.ko).numpy()
    assert got.sum() > 0
    for i in range(got.shape[0]):
        want = oracle_planes(ts.stones[i].reshape(-1).tolist(), 9, int(ts.ko[i]))
        np.testing.assert_array_equal(got[i], want, err_msg=f"board {i}")


def check_evaluator_with_ladders(mode):
    """ladder_mode "root" (the planes through ctx["ladders"]) or "full"
    (planes of every evaluated position) against the JAX evaluator in f32
    at 9x9 on midgame positions with ladders: NetEvals within 1e-5, and
    the planes do move the priors."""
    from sayuri_tpu.models import evaluator as JEV
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from test_torch_network import ATOL, seeded_variables

    net, variables, tnet = seeded_variables()
    env, js, _ = random_jax_states(n=9, b=6, moves=45, seed=29)
    ts = jax_to_torch(js)
    jfn = JEV.make_eval_fn(env, net, variables, symmetry="random", ladder_mode=mode)
    tfn = make_eval_fn(GoEnv(n=9), tnet, symmetry="random", ladder_mode=mode)
    if mode == "root":
        lp = _jax_planes(js.stones, js.size, js.ko)
        assert float(lp.sum()) > 0
        ref = jax.jit(jfn)(js, {"ladders": lp})
        got = tfn(ts, {"ladders": TL.ladder_planes_batch(ts.stones, ts.size, ts.ko)})
    else:
        ref = jax.jit(jfn)(js)
        got = tfn(ts)
    off = make_eval_fn(GoEnv(n=9), tnet, symmetry="random", ladder_mode="off")(ts)
    assert (off.priors - got.priors).abs().max() > ATOL   # the planes matter
    for k in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(ref, k)), getattr(got, k).numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_evaluator_root_ladders_matches_jax():
    check_evaluator_with_ladders("root")
