"""Card-only checks of the CUDA kernels (marker `gpu`). Without a
CUDA device every test here skips at run time; collection never touches
the card or the compiler. On the card:

    python -m pytest tests/test_torch_cuda.py -m gpu -p no:xdist
"""

import numpy as np
import pytest
import torch

from sayuri_tpu_torch.game import ladder as TL
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.ops import ladder_kernel as LK

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _positions(n, b, moves, seed):
    env = GoEnv(n=n)
    rng = np.random.RandomState(seed)
    s = env.new_batch(b)
    for _ in range(moves):
        legal = env.legal_action_mask(s).numpy()
        acts = np.array([rng.choice(np.nonzero(l)[0]) for l in legal], np.int32)
        s = env.step(s, torch.from_numpy(acts))
    legal = env.legal_action_mask(s).numpy()
    acts = np.array([rng.choice(np.nonzero(l)[0]) for l in legal], np.int32)
    return s, torch.from_numpy(acts)


@pytest.mark.parametrize("n", [9, 19])
def test_kernels_equal_twins(cuda, n):
    s, acts = _positions(n, 32, 3 * n, seed=n)
    args = (s.stones, s.size, s.ko, s.to_move)
    dargs = tuple(x.to(cuda) for x in args)
    TA.reset_launch_counts()
    for fn, plain, extra in (
        (TA.board_analysis, TA.board_analysis_plain, ()),
        (TA.step_and_analyze, TA.step_and_analyze_plain, (acts,)),
    ):
        want = plain(*args, *extra)
        got = fn(*dargs, *(x.to(cuda) for x in extra))
        torch.cuda.synchronize()
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v.to(got[k].dtype)), k
    assert TA.LAUNCHES == {"step_and_analyze": 1, "board_analysis": 1,
                           "ladder_prep": 0}


def test_wrapper_rejects_wrong_dtype(cuda):
    stones = torch.zeros((2, 9, 9), dtype=torch.int32, device=cuda)
    s32 = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="stones"):
        TA.board_analysis(stones, s32, s32, s32)


def _lanes(stones, size, ko):
    """The lanes ladder_planes_batch hands to run_greedy (all of them)."""
    seen = {}
    real = LK.run_greedy

    def spy(*args, **kw):
        seen["args"] = args[:7]
        return real(*args, **kw)

    LK.run_greedy = spy
    try:
        TL.ladder_planes_batch(stones, size, ko)
    finally:
        LK.run_greedy = real
    return seen["args"]


@pytest.mark.parametrize("n", [9, 19])
def test_ladder_kernels_equal_twins(cuda, n):
    """ladder_prep, run_greedy and run_chases against their plain twins on
    every output, the chase on every valid lane (not only forked ones);
    then ladder_planes_batch on the card against the CPU; then the
    launch counters: one launch per wrapper call."""
    s, _ = _positions(n, 32, 4 * n, seed=100 + n)
    args = (s.stones, s.size, s.ko)
    dargs = tuple(x.to(cuda) for x in args)
    TA.reset_launch_counts()
    LK.reset_launch_counts()
    want = TA.ladder_prep_plain(*args)
    got = TA.ladder_prep(*dargs)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k
    lanes = _lanes(*args)
    assert lanes[6].sum() > 0
    dl = tuple(x.to(cuda) for x in lanes)
    for kw in ({}, {"node_cap": 6}):
        res, forked = LK.run_greedy_plain(*lanes, n, **kw)
        kres, kforked = LK.run_greedy(*dl, n, **kw)
        assert torch.equal(kres.cpu(), res) and torch.equal(kforked.cpu(), forked)
    for kw in ({}, {"node_cap": 6, "max_forks": 2}):
        assert torch.equal(LK.run_chases(*dl, n, **kw).cpu(),
                           LK.run_chases_plain(*lanes, n, **kw))
    assert TA.LAUNCHES["ladder_prep"] == 1
    assert LK.LAUNCHES == {"run_greedy": 2, "run_chases": 2}
    planes = TL.ladder_planes_batch(*dargs)
    assert torch.equal(planes.cpu(), TL.ladder_planes_batch(*args))
    assert TA.LAUNCHES["ladder_prep"] == 2
    assert LK.LAUNCHES == {"run_greedy": 3, "run_chases": 3}


def test_ladder_wrappers_reject_wrong_dtype(cuda):
    words = torch.zeros((2, LK.ROWS), dtype=torch.int64, device=cuda)
    s32 = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="own_words"):
        LK.run_greedy(words, words, s32, s32, s32, s32, s32, 9)
    with pytest.raises(TypeError, match="own_words"):
        LK.run_chases(words, words, s32, s32, s32, s32, s32, 9)
    stones = torch.zeros((2, 9, 9), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="stones"):
        TA.ladder_prep(stones, s32, s32)
