"""Card-only checks of the CUDA kernels (marker `gpu`). Without a
CUDA device every test here skips at run time; collection never touches
the card or the compiler. On the card:

    python -m pytest tests/test_torch_cuda.py -m gpu -p no:xdist
"""

import numpy as np
import pytest
import torch

from sayuri_tpu_torch.game import board as TB
from sayuri_tpu_torch.game import ladder as TL
from sayuri_tpu_torch.game.positions import stress_positions
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.ops import flood as FK
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
    s = env.new_batch(b, device="cpu")
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
                           "ladder_prep": 0, "step_and_legal": 0}


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


@pytest.mark.parametrize("n", [9, 19])
def test_env_kernels_equal_plain(cuda, n):
    """step_and_legal, chain_labels and flood against their plain versions
    (colour masks of random positions as [3, B, n, n] nested boards); one
    launch per wrapper call."""
    s, acts = _positions(n, 32, 3 * n, seed=200 + n)
    acts[0] = n * n
    TA.reset_launch_counts()
    FK.reset_launch_counts()
    args = (s.stones, s.size, s.ko, s.to_move, acts)
    want = TA.step_and_legal_plain(*args)
    got = TA.step_and_legal(*(x.to(cuda) for x in args))
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v.to(got[k].dtype)), k
    mask = TB.board_mask(s.size, n)
    masks = torch.stack([(s.stones == c) & mask for c in (0, 1, 2)])
    seeds = torch.from_numpy(np.random.RandomState(n).rand(*masks.shape) < 0.05)
    assert torch.equal(FK.chain_labels(masks.to(cuda)).cpu(), TB.chain_labels_plain(masks))
    assert torch.equal(FK.flood(seeds.to(cuda), masks.to(cuda)).cpu(),
                       TB.flood_plain(seeds, masks))
    assert TA.LAUNCHES["step_and_legal"] == 1
    assert FK.LAUNCHES == {"flood": 1, "chain_labels": 1}


@pytest.mark.parametrize("n", [9, 19])
def test_kernels_on_stress_boards(cuda, n):
    """The stress boards of game/positions.py (a spiral snake chain, a
    checkerboard of one-stone chains, full and empty boards, the capture of
    a whole spiral, smaller games in the buffer) through every board kernel
    on the card, equal to the plain versions; the flood seeded on the
    masks' edges and next to empty cells (on the double spiral: one hole)."""
    args = stress_positions(n)[:5]
    dargs = tuple(x.to(cuda) for x in args)
    for fn, plain, k in ((TA.step_and_analyze, TA.step_and_analyze_plain, 5),
                         (TA.board_analysis, TA.board_analysis_plain, 4),
                         (TA.ladder_prep, TA.ladder_prep_plain, 3),
                         (TA.step_and_legal, TA.step_and_legal_plain, 5)):
        want = plain(*args[:k])
        got = fn(*dargs[:k])
        for key, v in want.items():
            assert torch.equal(got[key].cpu(), v.to(got[key].dtype)), (fn.__name__, key)
    mask = TB.board_mask(args[1], n)
    masks = torch.stack([(args[0] == c) & mask for c in (0, 1, 2)])
    assert torch.equal(FK.chain_labels(masks.to(cuda)).cpu(), TB.chain_labels_plain(masks))
    for seeds in (masks & TB.nbr_or(~masks), masks & TB.nbr_or(masks[0])):
        assert torch.equal(FK.flood(seeds.to(cuda), masks.to(cuda)).cpu(),
                           TB.flood_plain(seeds, masks))


def test_env_queries_on_card_equal_cpu(cuda):
    """GoEnv's step, legality, superko, score and ownership on CUDA states
    (kernels) equal the CPU run (plain versions)."""
    env = GoEnv(n=19)
    s, acts = _positions(19, 16, 80, seed=7)
    d, dacts = s.to(cuda), acts.to(cuda)
    for name, fn in (("legal", env.legal_action_mask), ("score", env.final_score),
                     ("ownership", env.ownership)):
        assert torch.equal(fn(d).cpu(), fn(s)), name
    sub = s.map(lambda x: x[:4])
    assert torch.equal(env.superko_action_mask(sub.to(cuda)).cpu(),
                       env.superko_action_mask(sub))
    for k, v in env.step(s, acts).fields().items():
        assert torch.equal(getattr(env.step(d, dacts), k).cpu(), v), k
    light, legal = env.step_batch_light(d, dacts)
    want, want_legal = env.step_batch_light(s, acts)
    assert torch.equal(legal.cpu(), want_legal)
    assert torch.equal(light.stones.cpu(), want.stones)


def test_fixpoint_wrappers_reject_wrong_input(cuda):
    ints = torch.zeros((2, 9, 9), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="stone_mask"):
        FK.chain_labels(ints)
    masks = torch.zeros((2, 9, 9), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="seed"):
        FK.flood(masks[:1], masks)
