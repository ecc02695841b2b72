"""The CPU twins of the port's two CUDA kernels against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_pallas_kernels.py
runs them) and against the reference-generated pass-dead goldens.
Every output is integer or bool, so every comparison is exact."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.ops import analysis as AK
from sayuri_tpu_torch.game import analysis as TGA
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.models.encoder import encode
from sayuri_tpu_torch.ops import analysis as TA
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = Path(__file__).parent / "goldens" / "passdead_goldens.json"


@pytest.fixture(autouse=True)
def interpret_mode():
    AK.INTERPRET = True
    yield
    AK.INTERPRET = False


def _assert_outputs_equal(ref, got, keys, tag):
    for k in keys:
        want = np.asarray(ref[k])
        have = got[k].numpy()
        if want.dtype == np.uint32:
            want = want.astype(np.int64)
        assert want.shape == have.shape, (tag, k, want.shape, have.shape)
        np.testing.assert_array_equal(want, have, err_msg=f"{tag}: {k}")


ANALYSIS_KEYS = ("legal", "libs", "ownership", "safe", "score_ownership")
STEP_KEYS = ANALYSIS_KEYS + ("new_stones", "n_captured", "new_ko", "new_hash")


def test_twins_match_pallas_kernels():
    """board_analysis / step_and_analyze twins == board_analysis_tpu /
    step_and_analyze_tpu at 9x9 B=4, one move with a pass lane."""
    _, js, _ = random_jax_states(n=9, b=4, moves=40, seed=7)
    ts = jax_to_torch(js)
    ref = AK.board_analysis_tpu(js.stones, js.size, js.ko, js.to_move)
    got = TA.board_analysis(ts.stones, ts.size, ts.ko, ts.to_move)
    _assert_outputs_equal(ref, got, ANALYSIS_KEYS, "board_analysis")

    legal = got["legal"].numpy()
    rng = np.random.RandomState(0)
    acts = np.array([rng.choice(np.nonzero(l)[0]) for l in legal], np.int32)
    acts[1] = 81  # pass
    ref = AK.step_and_analyze_tpu(js.stones, js.size, js.ko, js.to_move,
                                  jnp.asarray(acts))
    got = TA.step_and_analyze(ts.stones, ts.size, ts.ko, ts.to_move,
                              torch.from_numpy(acts))
    _assert_outputs_equal(ref, got, STEP_KEYS, "step_and_analyze")


def _golden_boards():
    data = json.load(open(GOLDEN))
    n = data["size"]
    env = GoEnv(n=n)
    out = []
    for rec in data["records"]:
        s = env.new_batch(1, komi=data["komi"], device="cpu")
        for _, v in rec["moves"]:
            s = env.step(s, torch.tensor([n * n if v < 0 else v], dtype=torch.int32))
        if rec["stones"] is not None:
            np.testing.assert_array_equal(
                s.stones.reshape(-1).numpy(), np.array(rec["stones"]),
                err_msg=f"{rec['name']}: replay mismatch",
            )
        out.append((rec, s))
    return data, out


def test_twin_area_planes_match_passdead_goldens():
    """Encoder planes 25-28 built from the analysis twin equal the
    reference's planes on every pass-dead golden (dragons included)."""
    data, boards = _golden_boards()
    env = GoEnv(n=data["size"])
    for rec, s in boards:
        ana = TA.board_analysis(s.stones, s.size, s.ko, s.to_move)
        planes = encode(env, s, torch.zeros(1, 9, 9, 4), ana["libs"],
                        ana["safe"], ana["score_ownership"])
        got = planes[0].permute(2, 0, 1)[25:29].numpy()
        want = np.array(rec["area_planes"], np.float32)
        np.testing.assert_array_equal(got, want, err_msg=rec["name"])


def test_twin_matches_pallas_on_golden_boards():
    """The goldens' boards (two-headed dragons, inner-region refinement)
    through the Pallas analysis kernel and the twin, both colours to move."""
    data, boards = _golden_boards()
    stones = torch.cat([s.stones for _, s in boards])
    b = stones.shape[0]
    z = torch.zeros(b, dtype=torch.int32)
    for tm in (0, 1):
        ref = AK.board_analysis_tpu(
            jnp.asarray(stones.numpy()), jnp.full((b,), 9, jnp.int32),
            jnp.full((b,), -1, jnp.int32), jnp.full((b,), tm, jnp.int32),
        )
        got = TA.board_analysis(stones, z + 9, z - 1, z + tm)
        _assert_outputs_equal(ref, got, ANALYSIS_KEYS, f"goldens tm={tm}")


def test_inner_slots_match_jax():
    from sayuri_tpu.game import analysis as JGA

    assert TGA.INNER_SLOTS == JGA.INNER_SLOTS == AK._INNER_SLOTS


def test_cpu_wrappers_use_twins_and_count_nothing():
    TA.reset_launch_counts()
    env = GoEnv(n=5)
    s = env.new_batch(2, device="cpu")
    out = TA.step_and_analyze(s.stones, s.size, s.ko, s.to_move,
                              torch.tensor([12, 25], dtype=torch.int32))
    assert out["new_stones"][0, 2, 2] == 1 and out["new_stones"][1].sum() == 0
    TA.board_analysis(s.stones, s.size, s.ko, s.to_move)
    light = TA.step_and_legal(s.stones, s.size, s.ko, s.to_move,
                              torch.tensor([12, 25], dtype=torch.int32))
    assert torch.equal(light["new_stones"], out["new_stones"])
    assert TA.LAUNCHES == {"step_and_analyze": 0, "board_analysis": 0,
                           "ladder_prep": 0, "step_and_legal": 0}


def test_wrappers_reject_unsupported_device():
    """Only CPU (twin) and CUDA (kernel) tensors are accepted."""
    stones = torch.zeros((2, 9, 9), dtype=torch.int8, device="meta")
    s32 = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TA.board_analysis(stones, s32, s32, s32)
