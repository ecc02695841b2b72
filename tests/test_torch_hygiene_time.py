"""The port's host-side copies and the opening book against the JAX
package: mcts/hygiene.py on random 9x9 stones, owners and legal masks
(every output equal); gtp/time_control.py over scripted time_settings,
kgs-time_settings and time_left sequences (every budget, buffer effect
and clock state equal); game/book.py generated from SGFs the port's
game_to_sgf writes (the same table and probe answers as the JAX book, a
book saved by one package loaded by the other)."""

import numpy as np
import pytest
import torch

from sayuri_tpu.game import book as JB
from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.gtp import time_control as JT
from sayuri_tpu.mcts import hygiene as JH
from sayuri_tpu_torch.game import book as TB
from sayuri_tpu_torch.game import sgf as SGF
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.gtp import time_control as TT
from sayuri_tpu_torch.mcts import hygiene as TH
from test_torch_board import random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 9


def _boards(seed, b=6):
    _, js, _ = random_jax_states(n=N, b=b, moves=50, seed=seed, pass_prob=0.05)
    return np.asarray(js.stones)


@pytest.mark.parametrize("seed", [0, 1])
def test_hygiene_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for stones in _boards(seed):
        np.testing.assert_array_equal(JH.chain_labels_np(stones), TH.chain_labels_np(stones))
        lbl = JH.chain_labels_np(stones)
        np.testing.assert_array_equal(JH.chain_liberty_map_np(stones, lbl),
                                      TH.chain_liberty_map_np(stones, lbl))
        safe = rng.rand(N, N) < 0.2
        safe_own = rng.randint(-1, 2, (N, N))
        own = rng.uniform(-1, 1, (N, N)).astype(np.float32)
        raw = rng.randint(-1, 2, (N, N))
        legal = np.append(rng.rand(N * N) < 0.7, True)
        sk = np.append(rng.rand(N * N) < 0.05, False)
        for color in (0, 1):
            owner = JH.owner_map(safe, safe_own, own, color)
            np.testing.assert_array_equal(owner, TH.owner_map(safe, safe_own, own, color))
            want = JH.dead_alive_masks(stones, owner, color)
            got = TH.dead_alive_masks(stones, owner, color)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(w, g)
            for last_pass in (False, True):
                args = (stones, want[0], color, 60, last_pass, lambda s: float(s.sum() % 7) - 3)
                assert JH.should_pass(*args) == TH.should_pass(*args)
            s = int(rng.randint(1 << 30))
            assert (JH.capture_all_dead_move(stones, owner, raw, legal, sk, color,
                                             np.random.RandomState(s))
                    == TH.capture_all_dead_move(stones, owner, raw, legal, sk, color,
                                                np.random.RandomState(s)))


def _clock_script(tc, log):
    """Drive one clock through settings, moves and time_left updates,
    logging every budget and state."""
    def snap(tag):
        for c in (0, 1):
            log.append((tag, c, tc.thinking_time(c, 19, 40), tc.buffer_effect(c, 19, 40),
                        tc.is_infinite(), tc.can_accumulate(c), tc.in_byo[c],
                        tc.maintime_left[c], tc.byotime_left[c], tc.stones_left[c],
                        tc.periods_left[c], tc.is_time_over(c)))
        log.append((tag, tc.to_string()))

    snap("start")
    tc.time_settings(120, 30, 5)
    snap("canadian")
    for i in range(12):
        tc.took_time(i % 2, 7.5 + i)
        snap(f"took {i}")
    tc.time_left(0, 40, 3)
    tc.time_left(1, 0, 0)
    snap("time_left")
    tc.kgs_time_settings("byoyomi", 60, 10, 3)
    for i in range(8):
        tc.took_time(0, 9.0 + 2 * i)
        snap(f"byo {i}")
    tc.time_left(1, 5, 2)
    snap("byo time_left")
    tc.kgs_time_settings("absolute", 30, 0, 0)
    tc.took_time(1, 4.0)
    snap("absolute")
    tc.kgs_time_settings("none", 0, 0, 0)
    snap("none")
    tc.lag_buffer = 0.3
    tc.time_settings(90, 0, 0)
    tc.update_lag_buffer(thinking_time=3.0, buffer_effect=0.5, elapsed=4.2,
                         lag_buffer_floor=0.3)
    snap("lag buffer")
    log.append(("lag", tc.lag_buffer))


def test_time_control_matches_jax():
    want, got = [], []
    _clock_script(JT.TimeControl(), want)
    _clock_script(TT.TimeControl(), got)
    assert want == got


def _write_games(tmp_path, games):
    paths = []
    for i, moves in enumerate(games):
        p = tmp_path / f"g{i}.sgf"
        p.write_text(SGF.game_to_sgf(19, 7.5, moves))
        paths.append(p)
    return paths


def test_book_matches_jax(tmp_path):
    n = 19
    d4, q16, c3, r17, k10 = 3 * n + 3, 15 * n + 15, 2 * n + 2, 16 * n + 16, 9 * n + 9
    games = ([[(0, d4), (1, q16), (0, c3)]] * 6 + [[(0, d4), (1, r17), (0, k10)]] * 5
             + [[(0, q16), (1, d4)]] * 3 + [[(0, k10), (1, None)]] * 5)
    paths = _write_games(tmp_path, games)
    jbook, tbook = JB.Book.generate(paths), TB.Book.generate(paths, device="cpu")
    assert jbook.table == tbook.table and len(tbook) >= 3
    jenv, env = JEnv(n=n), GoEnv(n=n)
    js, ts = jenv.new_state(komi=7.5), env.new_batch(1, device="cpu")
    legal = np.ones(n * n + 1, bool)
    assert JB.Book.probe(jbook, js, legal) == tbook.probe(ts, legal) == d4
    legal[d4] = False
    assert jbook.probe(js, legal) == tbook.probe(ts, legal) == k10
    # after D4 and Q16: C3 (6 games) over nothing else
    js = jenv.step(jenv.step(js, d4), q16)
    ts = env.step(env.step(ts, torch.tensor([d4], dtype=torch.int32)),
                  torch.tensor([q16], dtype=torch.int32))
    assert JB._hash_key(js) == TB._hash_key(ts)
    assert jbook.probe(js) == tbook.probe(ts) == c3
    # each package loads the other's file
    jbook.save(tmp_path / "j.json")
    tbook.save(tmp_path / "t.json")
    assert TB.Book.load(tmp_path / "j.json").table == JB.Book.load(tmp_path / "t.json").table
    assert TB.Book.load(tmp_path / "j.json").probe(ts) == c3
    small = env.new_batch(1, size=9, device="cpu")
    assert tbook.probe(small) is None
