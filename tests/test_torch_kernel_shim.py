"""The CUDA kernels themselves, run on the CPU through the g++ shim
(csrc/host_shim.h, ops/host_shim.py), against their plain versions cell
for cell and lane for lane: labels_kernel, flood_kernel,
step_analysis_kernel, board_analysis_kernel, ladder_prep_kernel and
step_legal_kernel, at 9x9 and 19x19, on seeded random positions and on
the stress boards of
game/positions.py (a snake chain, one-stone chains, full and empty boards,
smaller games in the buffer) plus hand-set moves for the light step
(a whole-spiral capture, a suicide, a pass, a joining move, a ko
capture); greedy_kernel and chase_kernel on the lanes that
ladder_planes_batch builds on random 9x9 and 19x19 positions, also with
limits small enough to bind. On the stress boards the labels and the
flood are also held against the JAX package's chain_labels and flood, and
the ladder prep against its Pallas kernel in interpret mode. Skips when
there is no C++ compiler.
"""

import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game import board as JB
from sayuri_tpu.ops import analysis as AK
from sayuri_tpu_torch.game import board as TB
from sayuri_tpu_torch.game.positions import random_positions, spiral, stress_positions
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.ops import host_shim as H
from sayuri_tpu_torch.ops import ladder_kernel as LK
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
    """One labelling of the played board: the same barriers on every
    board."""
    args = _positions(n, kind)
    got, bar = H.step_and_legal(lib, *args)
    _assert_equal(got, TA.step_and_legal_plain(*args), "step_legal_kernel")
    _report(f"step_legal_kernel {n}x{n} {kind}", bar)
    assert bar.unique().numel() == 1


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_ladder_prep_kernel(lib, n, kind):
    """One labelling of both colours and a liberty pass in its roots'
    phase: the same three barriers on every board."""
    args = _positions(n, kind)[:3]
    got, bar = H.ladder_prep(lib, *args)
    _assert_equal(got, TA.ladder_prep_plain(*args), "ladder_prep_kernel")
    _report(f"ladder_prep_kernel {n}x{n} {kind}", bar)
    assert bar.tolist() == [3] * bar.numel()


def _board(rows):
    """[n, n] int8 stones from strings of '.', 'X' (black), 'O' (white)."""
    return torch.tensor([[".XO".index(ch) for ch in r] for r in rows], dtype=torch.int8)


def _special_moves():
    """(stones, size, ko, to_move, action) of hand-set 9x9 moves, black to
    move: the capture of a whole spiral, a suicide into a white eye, a
    pass, a move that joins two chains, a ko capture."""
    stones, size, ko, to_move, action, names = stress_positions(9)
    spiral = names.index("double spiral, black to move")
    eye = ["........."] * 3 + ["....O...."] + ["...O.O..."] + ["....O...."] + ["........."] * 3
    join = ["........."] * 4 + ["...X.X..."] + ["........."] * 4
    ko_shape = ["........."] * 3 + ["...XO...."] + ["..XO.O..."] + ["...XO...."] + ["........."] * 3
    boards = [stones[spiral], _board(eye), _board(join), _board(join), _board(ko_shape)]
    acts = [int(action[spiral]), 4 * 9 + 4, 81, 4 * 9 + 4, 4 * 9 + 4]
    b = len(boards)
    z = torch.zeros(b, dtype=torch.int32)
    return (torch.stack(boards), z + 9, z - 1, z, torch.tensor(acts, dtype=torch.int32))


@pytest.mark.parametrize("schedule", [0, 1, 2, 3])
def test_step_legal_kernel_special_moves(lib, schedule):
    """The hand-set moves, in order and under random interleavings: every
    output equal to the plain version, the same barriers on every board,
    and each move does what it is set up for."""
    args = _special_moves()
    want = TA.step_and_legal_plain(*args)
    got, bar = H.step_and_legal(lib, *args, schedule=schedule)
    _assert_equal(got, want, f"special moves, schedule {schedule}")
    assert bar.unique().numel() == 1
    ncap, ko = want["n_captured"].tolist(), want["new_ko"].tolist()
    assert ncap[0] > 9 * 9 // 3                      # the whole spiral
    assert ncap[1] == 0 and int(want["new_stones"][1, 4, 4]) == 1   # suicide stays
    assert torch.equal(want["new_stones"][2], args[0][2])           # pass
    assert int(want["new_stones"][3, 4, 3:6].sum()) == 3            # joined
    assert ncap[4] == 1 and ko[4] == 4 * 9 + 3                      # ko
    assert not bool(want["legal"][4, ko[4]])


_LANES = {}
MAX_DESCENTS = 60   # lanes the shim runs in the chase test: short ones


def _pick(lanes, rows):
    return tuple(t[rows].contiguous() for t in lanes)


def _ladder_lanes(n):
    """The lanes ladder_planes_batch gives the searches on random n x n
    positions, made once per module: (greedy lanes: the valid ones;
    chase lanes: the forked ones of at most MAX_DESCENTS descents)."""
    if n not in _LANES:
        b, moves = (16, 64) if n == 9 else (8, 200)
        s, _ = random_positions(n, b, seed=n, max_moves=moves)
        g, c = H.search_lanes(s.stones, s.size, s.ko)
        g = _pick(g, (g[6] > 0).nonzero().flatten())
        descents = LK.chase_descents_plain(*c, n)[1]
        c = _pick(c, ((c[6] > 0) & (descents <= MAX_DESCENTS)).nonzero().flatten())
        _LANES[n] = (g, c)
    return _LANES[n]


@pytest.mark.parametrize("n,schedule", [(9, 0), (19, 0), (9, 1)])
def test_ladder_kernels(lib, n, schedule):
    """greedy_kernel and chase_kernel lane for lane against their plain
    twins; a ply costs far fewer warp-wide operations than the 98-124 it
    took on these lanes when a ply ran its floods one after another."""
    g, c = _ladder_lanes(n)
    res, forked, g_ops = H.run_greedy(lib, g, n, schedule=schedule)
    want_res, want_forked, steps = LK.greedy_steps_plain(*g, n)
    assert torch.equal(res, want_res) and torch.equal(forked, want_forked)
    assert forked.sum() > 0
    got, c_ops = H.run_chases(lib, c, n, schedule=schedule)
    want, descents = LK.chase_descents_plain(*c, n)
    assert torch.equal(got, want)
    assert c[0].shape[0] >= 8
    assert (got == LK.HUNTER_GOOD).any() and (got == LK.PREY_GOOD).any()
    per_step = g_ops.sum().item() / steps.sum().item()
    per_descent = c_ops.sum().item() / descents.sum().item()
    print(f"{n}x{n}: greedy {g[0].shape[0]} lanes, {per_step:.1f} warp ops a step; "
          f"chase {c[0].shape[0]} lanes, {per_descent:.1f} warp ops a descent")
    assert per_descent < 75 and per_step < 75


def test_ladder_kernel_limits(lib):
    """A node budget of 6 descents and a 2-frame (then 1-frame) stack: the
    freeze paths read PREY_GOOD as in the twins, and the limits bind."""
    n = 9
    g, c = _ladder_lanes(n)
    free_g, _, _ = H.run_greedy(lib, g, n)
    res, forked, _ = H.run_greedy(lib, g, n, node_cap=6)
    want_res, want_forked = LK.run_greedy_plain(*g, n, node_cap=6)
    assert torch.equal(res, want_res) and torch.equal(forked, want_forked)
    assert (res != free_g).any()
    free_c, _ = H.run_chases(lib, c, n)
    for cap, forks in ((6, 2), (LK.NODE_CAP, 1)):
        got, _ = H.run_chases(lib, c, n, node_cap=cap, max_forks=forks)
        assert torch.equal(got, LK.run_chases_plain(*c, n, node_cap=cap, max_forks=forks))
        assert (got != free_c).any(), (cap, forks)


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


def _flood_args(stones, size):
    """The colour masks ([3, B, n, n]) seeded at their cells next to an
    empty cell."""
    masks = H.colour_masks(stones, size)
    return masks & TB.nbr_or(masks[0]), masks


# warp-wide operations of a 19x19 board outside the growth loop: 6
# shuffles in (one an input to pair the loaded chunks, two an input to take
# the rows), 12 out; a growth step takes 3
FLOOD_FIXED_OPS_19, FLOOD_STEP_OPS = 18, 3


@pytest.mark.parametrize("n", [9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_flood_kernel(lib, n, kind):
    """One warp a board and no block barrier (the shim wrapper checks);
    a board's warp-wide operations are a fixed part plus 3 a vertical
    growth step, the last step finding no growth."""
    seeds, masks = _flood_args(*_positions(n, kind)[:2])
    got, ops = H.flood(lib, seeds, masks)
    assert torch.equal(got, TB.flood_plain(seeds, masks))
    b = ops.tolist()
    print(f"flood_kernel {n}x{n} {kind}: warp ops a board median "
          f"{statistics.median(b)}, max {max(b)}")
    if n == 19:
        steps = (ops - FLOOD_FIXED_OPS_19) / FLOOD_STEP_OPS
        assert bool((steps >= 1).all()) and bool((steps == steps.round()).all())


def test_flood_kernel_at_any_alignment(lib):
    """Boards that start at every byte offset of a 16-byte chunk (views into
    one buffer): the kernel loads aligned 16-byte chunks around each board
    and takes only the board's bits."""
    rng = np.random.RandomState(3)
    n, b = 19, 5
    for off in range(17):
        allowed = torch.from_numpy(rng.rand(off + b * n * n) < 0.6)
        seed = torch.from_numpy(rng.rand(off + b * n * n) < 0.05)
        a, s = (x[off:].view(b, n, n) for x in (allowed, seed))
        assert a.data_ptr() % 16 == (allowed.data_ptr() + off) % 16
        got, _ = H.flood(lib, s, a)
        assert torch.equal(got, TB.flood_plain(s, a)), off


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
        got, _ = H.ladder_prep(lib, *args[:3], schedule=schedule)
        _assert_equal(got, TA.ladder_prep_plain(*args[:3]), f"prep {kind} {schedule}")
        seeds, masks = _flood_args(*args[:2])
        got, _ = H.flood(lib, seeds, masks, schedule=schedule)
        assert torch.equal(got, TB.flood_plain(seeds, masks))


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


@pytest.mark.parametrize("n", [9, 19])
def test_stress_flood_matches_jax(lib, n):
    """The stress masks' floods through the JAX package's flood, the plain
    version and the kernel; on the spiral the flood climbs one row a step
    through every turn of the snake."""
    seeds, masks = _flood_args(*_positions(n, "stress")[:2])
    want = np.asarray(jax.jit(jax.vmap(jax.vmap(JB.flood)))(seeds.numpy(), masks.numpy()))
    np.testing.assert_array_equal(want, TB.flood_plain(seeds, masks))
    got, ops = H.flood(lib, seeds, masks)
    np.testing.assert_array_equal(want, got)
    assert int(ops.max()) > 2 * int(ops.min())


@pytest.mark.parametrize("n", [9, 19])
def test_stress_ladder_prep_matches_jax(lib, n, monkeypatch):
    """The stress boards through the JAX package's ladder prep (the Pallas
    kernel in interpret mode, as tests/test_pallas_kernels.py runs it), the
    plain version and the kernel: labels and both legality maps on every
    cell; nlibs, lib1 and lib2 on chain cells, which are all the front end
    reads (off a chain the Pallas kernel leaves partial values there)."""
    monkeypatch.setattr(AK, "INTERPRET", True)
    stones, size, ko = _positions(n, "stress")[:3]
    ref = AK.ladder_prep_tpu(*(jnp.asarray(t.numpy()) for t in (stones, size, ko)))
    got, _ = H.ladder_prep(lib, stones, size, ko)
    plain = TA.ladder_prep_plain(stones, size, ko)
    chain = got["labels"].numpy() >= 0
    assert chain.any() and not chain.all()
    for k, want in ref.items():
        want = np.asarray(want).reshape(got[k].shape)
        for out in (got, plain):
            if k in ("labels", "legal_black", "legal_white"):
                np.testing.assert_array_equal(want, out[k].numpy(), err_msg=k)
            else:
                np.testing.assert_array_equal(want[chain], out[k].numpy()[chain],
                                              err_msg=k)


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
