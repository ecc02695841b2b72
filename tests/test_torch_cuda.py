"""Card-only checks of the CUDA analysis kernels (marker `gpu`). Without a
CUDA device every test here skips at run time; collection never touches
the card or the compiler. On the card:

    python -m pytest tests/test_torch_cuda.py -m gpu -p no:xdist
"""

import numpy as np
import pytest
import torch

from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.ops import analysis as TA

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
    assert TA.LAUNCHES == {"step_and_analyze": 1, "board_analysis": 1}


def test_wrapper_rejects_wrong_dtype(cuda):
    stones = torch.zeros((2, 9, 9), dtype=torch.int32, device=cuda)
    s32 = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="stones"):
        TA.board_analysis(stones, s32, s32, s32)
