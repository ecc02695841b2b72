"""The CUDA board kernels themselves, run on the CPU through the g++ shim
(csrc/host_shim.h, ops/host_shim.py), against their plain versions cell
for cell: labels_kernel, flood_kernel, step_analysis_kernel,
board_analysis_kernel and step_legal_kernel, at 9x9 and 19x19, on seeded
random positions and on the stress boards of game/positions.py (a snake
chain, one-stone chains, full and empty boards, smaller games in the
buffer). The stress masks' labels are also held against the JAX
package's chain_labels. Skips when there is no C++ compiler.
"""

import statistics

import jax
import numpy as np
import pytest
import torch

from sayuri_tpu.game import board as JB
from sayuri_tpu_torch.game import board as TB
from sayuri_tpu_torch.game.positions import random_positions, spiral, stress_positions
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.ops import host_shim as H


@pytest.fixture(scope="module")
def lib():
    if H.find_cxx() is None:
        pytest.skip("needs a C++ compiler (g++ or $CXX)")
    return H.build()


_POSITIONS = {}


def _positions(n, kind):
    """(stones, size, ko, to_move, action) of 8 random positions or of the
    stress boards, made once per module."""
    key = (n, kind)
    if key not in _POSITIONS:
        if kind == "random":
            s, a = random_positions(n, 8, seed=n, max_moves=4 * n)
            _POSITIONS[key] = (s.stones, s.size, s.ko, s.to_move, a)
        else:
            _POSITIONS[key] = stress_positions(n, seed=n)[:5]
    return _POSITIONS[key]


def _assert_equal(got, want, tag):
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), f"{tag}: {k}"


def _report(name, barriers):
    b = barriers.tolist()
    print(f"{name}: barriers a board median {statistics.median(b)}, max {max(b)}")


KINDS = ["random", "stress"]


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_step_analysis_kernel(lib, n, kind):
    args = _positions(n, kind)
    got, bar = H.step_and_analyze(lib, *args)
    _assert_equal(got, TA.step_and_analyze_plain(*args), "step_analysis_kernel")
    _report(f"step_analysis_kernel {n}x{n} {kind}", bar)
    # the play half and the analysis: 4 + 11 barriers, 3 more a Benson
    # iteration after the first, more only where an eye needs refining
    assert int(bar.min()) >= 15


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_board_analysis_kernel(lib, n, kind):
    args = _positions(n, kind)[:4]
    got, bar = H.board_analysis(lib, *args)
    _assert_equal(got, TA.board_analysis_plain(*args), "board_analysis_kernel")
    _report(f"board_analysis_kernel {n}x{n} {kind}", bar)
    assert int(bar.min()) >= 11


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_step_legal_kernel(lib, n, kind):
    args = _positions(n, kind)
    got, bar = H.step_and_legal(lib, *args)
    _assert_equal(got, TA.step_and_legal_plain(*args), "step_legal_kernel")
    _report(f"step_legal_kernel {n}x{n} {kind}", bar)


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_labels_kernel(lib, n, kind):
    """Labels of the colour masks ([3, B, n, n]): two barriers a board,
    whatever the board."""
    stones, size = _positions(n, kind)[:2]
    masks = H.colour_masks(stones, size)
    got, bar = H.chain_labels(lib, masks)
    assert torch.equal(got, TB.chain_labels_plain(masks))
    _report(f"labels_kernel {n}x{n} {kind}", bar)
    assert bar.tolist() == [2] * bar.numel()


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_flood_kernel(lib, n, kind):
    stones, size = _positions(n, kind)[:2]
    masks = H.colour_masks(stones, size)
    seeds = masks & TB.nbr_or(masks[0])
    got, bar = H.flood(lib, seeds, masks)
    assert torch.equal(got, TB.flood_plain(seeds, masks))
    _report(f"flood_kernel {n}x{n} {kind}", bar)


@pytest.mark.parametrize("schedule", [1, 2, 3])
def test_kernels_under_interleaving(lib, schedule):
    """Fibers drawn in random order and yielding at random before atomics,
    so that the lock-free unions meet each other mid-way: the same
    outputs."""
    for kind in KINDS:
        args = _positions(19, kind)
        got, _ = H.step_and_analyze(lib, *args, schedule=schedule)
        _assert_equal(got, TA.step_and_analyze_plain(*args), f"{kind} {schedule}")
        masks = H.colour_masks(*args[:2])
        got, _ = H.chain_labels(lib, masks, schedule=schedule)
        assert torch.equal(got, TB.chain_labels_plain(masks))


@pytest.mark.parametrize("n", [9, 19])
def test_stress_labels_match_jax(lib, n):
    """The stress masks through the JAX package's chain_labels, the plain
    version and the kernel; the spiral is one chain of about n * n / 2
    stones."""
    stones, size = _positions(n, "stress")[:2]
    masks = H.colour_masks(stones, size).numpy()
    want = np.asarray(jax.jit(jax.vmap(jax.vmap(JB.chain_labels)))(masks))
    np.testing.assert_array_equal(want, TB.chain_labels_plain(torch.from_numpy(masks)))
    np.testing.assert_array_equal(want, H.chain_labels(lib, torch.from_numpy(masks))[0])
    sp = spiral(n)
    lbl = TB.chain_labels_plain(torch.from_numpy(sp)[None])[0]
    assert set(lbl[torch.from_numpy(sp)].tolist()) == {0}
    assert sp.sum() > n * n // 2 - n


def test_analysis_kernels_on_passdead_goldens(lib):
    """The pass-dead goldens (two-headed dragons, false eyes: the
    inner-region refinement), both colours to move, through both analysis
    kernels; the refinement adds barriers on some of them."""
    from tests.test_torch_analysis import _golden_boards

    _, boards = _golden_boards()
    stones = torch.cat([s.stones for _, s in boards] * 2)
    b, n = stones.shape[0], stones.shape[-1]
    z = torch.zeros(b, dtype=torch.int32)
    to_move = (torch.arange(b) >= b // 2).to(torch.int32)
    args = (stones, z + n, z - 1, to_move)
    legal = TB.legal_moves(*args[:2], to_move, z - 1, plain=True)
    action = torch.tensor([int(l.nonzero()[len(l.nonzero()) // 2]) if l.any() else n * n
                           for l in legal], dtype=torch.int32)
    got, bar = H.board_analysis(lib, *args)
    _assert_equal(got, TA.board_analysis_plain(*args), "board_analysis_kernel goldens")
    _report("board_analysis_kernel pass-dead goldens", bar)
    assert int(bar.max()) > 14
    got, bar = H.step_and_analyze(lib, *args, action)
    _assert_equal(got, TA.step_and_analyze_plain(*args, action),
                  "step_analysis_kernel goldens")
