"""The port's ladder planes against the JAX package, exact.

- the ladder prep twin (ops/analysis.py ``ladder_prep_plain``) against the
  Pallas ``ladder_prep_tpu`` in interpret mode, as
  tests/test_pallas_kernels.py runs it;
- the candidate dict against ``jax.vmap(_prep_candidates)``;
- the greedy and fork-stack search twins (ops/ladder_kernel.py) against
  ``run_greedy_xla`` / ``run_chases_xla``, lane by lane, on the lanes the
  JAX front end assembles, with the default limits and with limits small
  enough that lanes hit them;
- the launch counters and device checks of the wrappers.

``ladder_planes_batch`` itself is held against the JAX front end and the
recursive oracle in test_torch_ladder_planes.py.

Positions are random legal games made with numpy from a seed; one batch is
a 9x9 board in a 13x13 buffer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game import board as JB
from sayuri_tpu.game import ladder as JL
from sayuri_tpu.ops import analysis as AK
from sayuri_tpu.ops import ladder_kernel as JLK
from sayuri_tpu_torch.game import ladder as TL
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.ops import ladder_kernel as LK
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (n, batch, moves, board size or None for n)
CASES = {"9x9": (9, 6, 40, None), "19x19": (19, 3, 150, None),
         "9in13": (13, 4, 40, 9)}


@functools.lru_cache(maxsize=None)
def _states(case, seed=0):
    n, b, moves, size = CASES[case]
    if size is None:
        return random_jax_states(n=n, b=b, moves=moves, seed=seed + n)[1]
    # a size x size game placed in the top-left corner of the n x n buffer
    js = random_jax_states(n=size, b=b, moves=moves, seed=seed + n)[1]
    stones = np.zeros((b, n, n), np.int8)
    stones[:, :size, :size] = np.asarray(js.stones)
    ko = np.asarray(js.ko)
    ko = np.where(ko >= 0, (ko // size) * n + ko % size, ko).astype(np.int32)
    return js.replace(stones=jnp.asarray(stones), ko=jnp.asarray(ko),
                      size=jnp.full((b,), size, jnp.int32))


@jax.jit
def _jax_lanes(stones, size, ko):
    """The JAX front end's candidate prep and lane assembly
    (ladder.py:226-272, as tools/diff_ladder.py:25-60 replicates it):
    (prep dict, seven [L] / [L, 32] arrays)."""
    b, n = stones.shape[0], stones.shape[-1]
    M = JL.max_chains(n)
    prep = jax.vmap(lambda s, z, k: JL._prep_candidates(s, z, k, M))(stones, size, ko)
    cand_v, nlibs = prep["cand_v"], prep["nlibs"]
    valid = cand_v >= 0
    mask = jax.vmap(lambda z: JB.board_mask(z, n))(size)
    bw = JLK.pack_bitboards((stones == 1) & mask)[:, None]
    ww = JLK.pack_bitboards((stones == 2) & mask)[:, None]
    black = (prep["color"] == 0)[..., None]
    own, opp = jnp.where(black, bw, ww), jnp.where(black, ww, bw)
    ok0 = valid & ((nlibs == 1) | ((nlibs == 2) & prep["legal_a"]))
    ok1 = valid & (nlibs == 2) & prep["legal_b"]

    def lanes(x):
        return jnp.broadcast_to(x[:, :, None], (b, M, 2) + x.shape[2:]).reshape(
            (b * M * 2,) + x.shape[2:])

    return prep, (
        lanes(own), lanes(opp), lanes(jnp.broadcast_to(size[:, None], (b, M))),
        lanes(jnp.broadcast_to(ko[:, None], (b, M))),
        lanes(jnp.maximum(cand_v, 0)),
        jnp.stack([jnp.where(nlibs == 1, -1, prep["l1"]), prep["l2"]], 2).reshape(-1),
        jnp.stack([ok0, ok1], 2).reshape(-1).astype(jnp.int32))


@functools.lru_cache(maxsize=None)
def _jax_front_end(case):
    js = _states(case)
    return _jax_lanes(js.stones, js.size, js.ko)


@functools.lru_cache(maxsize=None)
def _active_lanes(case):
    """The JAX lanes that are valid, as (jax arrays, int32 torch tensors)."""
    lanes = _jax_front_end(case)[1]
    keep = np.nonzero(np.asarray(lanes[-1]))[0]
    jl = [x[keep] for x in lanes]
    return jl, [torch.from_numpy(np.asarray(x).astype(np.int32)) for x in jl]


@pytest.mark.parametrize("case", ["9x9", "19x19"])
def test_prep_matches_pallas_prep(case, monkeypatch):
    """Labels and both legality maps on every cell; nlibs, lib1 and lib2 on
    chain cells, which are all the front end reads (off a chain the Pallas
    kernel leaves partial values there)."""
    monkeypatch.setattr(AK, "INTERPRET", True)
    js = _states(case)
    ts = jax_to_torch(js)
    ref = AK.ladder_prep_tpu(js.stones, js.size, js.ko)
    got = TA.ladder_prep(ts.stones, ts.size, ts.ko)
    chain = got["labels"].numpy() >= 0
    assert chain.any()
    for k in ("labels", "legal_black", "legal_white"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(), err_msg=k)
    for k in ("nlibs", "lib1", "lib2"):
        np.testing.assert_array_equal(np.asarray(ref[k])[chain], got[k].numpy()[chain],
                                      err_msg=k)


@pytest.mark.parametrize("case", ["9x9", "19x19", "9in13"])
def test_candidates_match_jax(case):
    """cand_v and labels everywhere; the per-candidate facts on the valid
    slots (an empty slot reads cell 0, where the two preps differ)."""
    js = _states(case)
    ts = jax_to_torch(js)
    ref = _jax_front_end(case)[0]
    got = TL._prep_candidates(ts.stones, ts.size, ts.ko)
    b = ts.stones.shape[0]
    cand_v = np.asarray(ref["cand_v"])
    np.testing.assert_array_equal(cand_v, got["cand_v"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["labels"]).reshape(b, -1),
                                  got["labels"].numpy())
    valid = cand_v >= 0
    assert valid.sum() >= 4
    for k in ("l1", "l2", "nlibs", "color", "legal_a", "legal_b"):
        np.testing.assert_array_equal(np.asarray(ref[k])[valid],
                                      got[k].numpy()[valid], err_msg=k)


@pytest.mark.parametrize("case", ["9x9", "19x19", "9in13"])
def test_search_twins_match_jax(case):
    """run_greedy_plain (result and forked) and run_chases_plain against the
    XLA search on every valid lane; the chase runs on all of them, not only
    the forked ones, so the fork stack sees many trees."""
    n = CASES[case][0]
    jl, tl = _active_lanes(case)
    res, forked = JLK.run_greedy_xla(*jl, n)
    got_res, got_forked = LK.run_greedy_plain(*tl, n)
    np.testing.assert_array_equal(np.asarray(res), got_res.numpy())
    np.testing.assert_array_equal(np.asarray(forked), got_forked.numpy())
    assert got_forked.sum() > 0
    chase = LK.run_chases_plain(*tl, n)
    np.testing.assert_array_equal(np.asarray(JLK.run_chases_xla(*jl, n)), chase.numpy())
    assert (chase == LK.HUNTER_GOOD).any() and (chase == LK.PREY_GOOD).any()


def test_search_limits_match_jax(monkeypatch):
    """A node budget of 6 descents and a 2-frame stack: lanes freeze at
    PREY_GOOD in both packages alike, and the limits do bind (results
    differ from the unlimited search)."""
    n = 9
    jl, tl = _active_lanes("9x9")
    free_g, _ = LK.run_greedy_plain(*tl, n)
    free_c = LK.run_chases_plain(*tl, n)
    monkeypatch.setattr(JLK, "NODE_CAP", 6)
    monkeypatch.setattr(JLK, "MAX_FORKS", 2)
    res, forked = JLK.run_greedy_xla(*jl, n)
    got_res, got_forked = LK.run_greedy_plain(*tl, n, node_cap=6)
    np.testing.assert_array_equal(np.asarray(res), got_res.numpy())
    np.testing.assert_array_equal(np.asarray(forked), got_forked.numpy())
    assert (got_res != free_g).any()
    chase = LK.run_chases_plain(*tl, n, node_cap=6, max_forks=2)
    np.testing.assert_array_equal(np.asarray(JLK.run_chases_xla(*jl, n)), chase.numpy())
    assert (chase != free_c).any()
    stack_only = LK.run_chases_plain(*tl, n, max_forks=1)
    assert (stack_only != free_c).any()


def test_cpu_wrappers_use_twins_and_count_nothing():
    TA.reset_launch_counts()
    LK.reset_launch_counts()
    js = _states("9x9")
    ts = jax_to_torch(js)
    TL.ladder_planes_batch(ts.stones, ts.size, ts.ko)
    assert TA.LAUNCHES["ladder_prep"] == 0
    assert LK.LAUNCHES == {"run_greedy": 0, "run_chases": 0}


def test_wrappers_reject_unsupported_device():
    words = torch.zeros((2, LK.ROWS), dtype=torch.int32, device="meta")
    s32 = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        LK.run_greedy(words, words, s32, s32, s32, s32, s32, 9)
    with pytest.raises(ValueError, match="unsupported device"):
        LK.run_chases(words, words, s32, s32, s32, s32, s32, 9)
    stones = torch.zeros((2, 9, 9), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TA.ladder_prep(stones, s32, s32)


def test_pack_bitboards_matches_jax():
    rng = np.random.RandomState(5)
    mask = rng.rand(3, 19, 19) > 0.5
    ref = np.asarray(JLK.pack_bitboards(jnp.asarray(mask)))
    got = LK.pack_bitboards(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())
