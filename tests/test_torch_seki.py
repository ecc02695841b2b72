"""The port's seki (game/analysis.py: seki_points, seki_at,
safe_area(mark_seki=True)) against the JAX package's, on random 7x7 and
9x9 positions, on the hand-built seki boards of test_seki.py, on the
pass-dead golden boards and on the 9x9 stress boards of game/positions.py.
Every value is equal."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game import analysis as JA
from sayuri_tpu_torch.game import analysis as TA
from sayuri_tpu_torch.game.positions import stress_positions
from sayuri_tpu_torch.game.state import GoEnv
from test_torch_board import random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the boards of test_seki.py (x black, o white): simple no-eye seki, a
# three-liberty union (false seki), an atari string, the squared four, a
# big eye space, a three-space eye; then a 1-2-3 eye-space ladder of
# inner strings built here
DIAGRAMS = [
    "x.ox...\nx.ox...\nxxox...\nooxx...\n.oo....\n.......\n.......",
    ".x.ox..\noxoox..\n.ooxx..\nooxx...\nxxx....\n.......\n.......",
    "xo.....\nxo.....\n.o.....\n.......\n.......\n.......\n.......",
    "xx.ox..\nx.oox..\nooox...\nxxxx...\n.......\n.......\n.......",
    "xxxxx.o\nx....xo\nooooxxo\nxxxooo.\n..x....\n.......\n.......",
    "xx.ox..\noooox..\nxxxx...\n.......\n.......\n.......\n.......",
    "xxo.o..\nx.oxo..\n.xoxo..\nxxoxo..\nooxoo..\n.ooo...\n.......",
]


def _diagram_boards(n=7):
    out = np.zeros((len(DIAGRAMS), n, n), np.int8)
    for i, d in enumerate(DIAGRAMS):
        for y, row in enumerate(d.splitlines()):
            for x, ch in enumerate(row):
                out[i, y, x] = {"x": 1, "o": 2, ".": 0}[ch]
    return out


def _golden_boards():
    data = json.loads((Path(__file__).parent / "goldens/passdead_goldens.json").read_text())
    n = data["size"]
    env = GoEnv(n=n)
    boards = []
    for rec in data["records"]:
        s = env.new_batch(1, komi=data["komi"], device="cpu")
        for _, v in rec["moves"]:
            s = env.step(s, torch.tensor([n * n if v < 0 else v], dtype=torch.int32))
        boards.append(s.stones[0].numpy())
    return np.stack(boards)


def _cases():
    """The boards grouped by buffer size (one JAX compile each)."""
    _, j7, _ = random_jax_states(n=7, b=12, moves=34, seed=3, pass_prob=0.02)
    _, j9, _ = random_jax_states(n=9, b=8, moves=70, seed=5, pass_prob=0.02)
    stress = stress_positions(9)
    dia, gold = _diagram_boards(), _golden_boards()
    s7 = np.concatenate([np.asarray(j7.stones), dia])
    z7 = np.concatenate([np.asarray(j7.size), np.full(len(dia), 7, np.int32)])
    s9 = np.concatenate([np.asarray(j9.stones), gold, stress[0].numpy()])
    z9 = np.concatenate([np.asarray(j9.size), np.full(len(gold), 9, np.int32),
                         stress[1].numpy()])
    return [("7x7: random and diagrams", s7, z7.astype(np.int32)),
            ("9x9: random, pass-dead goldens, stress", s9, z9.astype(np.int32))]


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seki_points_and_safe_area_match_jax(case):
    _, stones, size = case
    js, jsz = jnp.asarray(stones), jnp.asarray(size, jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(JA.seki_points))(js, jsz))
    ts, tsz = torch.from_numpy(stones.copy()), torch.from_numpy(size.astype(np.int32))
    np.testing.assert_array_equal(want, TA.seki_points(ts, tsz).numpy())
    want_safe = np.asarray(jax.jit(jax.vmap(
        lambda s, z: JA.safe_area(s, z, mark_seki=True)))(js, jsz))
    np.testing.assert_array_equal(want_safe, TA.safe_area(ts, tsz, mark_seki=True).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(JA.safe_area))(js, jsz)), TA.safe_area(ts, tsz).numpy())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seki_at_every_vertex_matches_jax(case):
    _, stones, size = case
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    per_vertex = jax.vmap(JA.seki_at, (None, None, 0))
    want = np.asarray(jax.jit(jax.vmap(per_vertex, (0, 0, None)))(
        jnp.asarray(stones), jnp.asarray(size, jnp.int32), jnp.arange(nn)))
    ts = torch.from_numpy(stones.copy()).repeat_interleave(nn, 0)
    tsz = torch.from_numpy(size.astype(np.int32)).repeat_interleave(nn, 0)
    got = TA.seki_at(ts, tsz, torch.arange(nn).repeat(b)).view(b, nn)
    np.testing.assert_array_equal(want, got.numpy())


def test_cases_hold_seki_points():
    """The boards above reach the branches of the test: the simple seki,
    the three-liberty union, the killable squared four."""
    stones, size = CASES[0][1][-len(DIAGRAMS):], CASES[0][2][-len(DIAGRAMS):]
    pts = TA.seki_points(torch.from_numpy(stones.copy()), torch.from_numpy(size)).numpy()
    assert pts[0, 0, 1] and pts[0, 1, 1] and pts[0].sum() == 2
    assert pts[1].any()
    assert not pts[2].any() and not pts[3, 1, 1]
