"""The port's host pattern layer (sayuri_tpu_torch/pattern: pattern.py,
mm.py, gammas.py) against the JAX package's: pattern_key at dist 1-3,
chain_liberty_counts and tactical_features equal on seeded boards; fit_mm
gives the same floats; GammasDict round-trips through its file and its
policy equals the JAX one; train_from_sgfs on SGFs written here gives a
file byte for byte the JAX package's (the port replays the games on the
CPU)."""

import numpy as np
import pytest

from sayuri_tpu.pattern import gammas as JGM
from sayuri_tpu.pattern import mm as JMM
from sayuri_tpu.pattern import pattern as JP
from sayuri_tpu_torch.game import sgf as SGF
from sayuri_tpu_torch.pattern import gammas as TGM
from sayuri_tpu_torch.pattern import mm as TMM
from sayuri_tpu_torch.pattern import pattern as TP


def random_boards(n, count, seed):
    """Seeded boards: stones of both colors and empty points, some with
    chains in atari (dense fills)."""
    rng = np.random.RandomState(seed)
    fill = rng.uniform(0.2, 0.8, count)
    return [rng.choice(3, size=(n, n), p=[1 - f, f / 2, f / 2]).astype(np.int8)
            for f in fill]


@pytest.mark.parametrize("dist", [1, 2, 3])
def test_pattern_key_matches_jax(dist):
    for n, board in [(n, b) for n in (5, 7, 9) for b in random_boards(n, 2, 10 * dist + n)]:
        for to_move in (0, 1):
            for v in range(n * n):
                assert (TP.pattern_key(board, n, v, to_move, dist)
                        == JP.pattern_key(board, n, v, to_move, dist)), (n, v, to_move)


def test_liberties_and_tacticals_match_jax():
    for i, board in enumerate(random_boards(7, 6, seed=3)):
        libs = TP.chain_liberty_counts(board, 7)
        np.testing.assert_array_equal(libs, JP.chain_liberty_counts(board, 7))
        for to_move in (0, 1):
            for v in range(49):
                last = (v * 7 + i) % 50 - 1          # -1, none and board points
                last = None if last == 48 else last
                assert (TP.tactical_features(board, 7, v, to_move, last, libs=libs)
                        == JP.tactical_features(board, 7, v, to_move, last)), (i, v)


def _competitions(seed, count=40, feats=12):
    rng = np.random.RandomState(seed)
    comps = []
    for _ in range(count):
        teams = [tuple(f"f{j}" for j in sorted(set(rng.randint(0, feats, rng.randint(1, 4)))))
                 for _ in range(rng.randint(2, 7))]
        comps.append((int(rng.randint(len(teams))), teams))
    return comps


@pytest.mark.parametrize("iterations", [1, 30])
def test_fit_mm_matches_jax(iterations):
    comps = _competitions(iterations)
    want = JMM.fit_mm(comps, iterations=iterations)
    got = TMM.fit_mm(comps, iterations=iterations)
    assert list(got.items()) == list(want.items())


def test_gammas_dict_round_trip_and_policy(tmp_path):
    rng = np.random.RandomState(5)
    boards = random_boards(7, 3, seed=8)
    table = {str(TP.pattern_key(b, 7, v, 0, 2)): float(rng.uniform(0.2, 5.0))
             for b in boards for v in range(0, 49, 2)}
    table.update({"dist_last:1": 2.5, "own_atari_adjacent": 0.4, "opp_2libs_adjacent": 1.7})
    gd = TGM.GammasDict(table, dist=2)
    gd.save(tmp_path / "g.json")
    back = TGM.GammasDict.load(tmp_path / "g.json")
    assert back.table == gd.table and back.dist == 2 and len(back) == len(table)
    jgd = JGM.GammasDict.load(tmp_path / "g.json")
    for i, b in enumerate(boards):
        legal = b.reshape(-1) == 0
        legal = np.append(legal, True)
        own = rng.uniform(-1, 1, 49).astype(np.float32)
        for kw in (dict(), dict(last_move=int(np.nonzero(b.reshape(-1))[0][i]), ownership=own)):
            np.testing.assert_array_equal(back.policy(b, 7, i % 2, legal, **kw),
                                          jgd.policy(b, 7, i % 2, legal, **kw))
    assert TGM.GammasDict.MC_OWNER_GAMMAS == JGM.GammasDict.MC_OWNER_GAMMAS


def write_sgfs(path, n=7, games=3, moves=24, seed=0):
    """Random legal games played with the port's env on the CPU, written as
    SGF files (one with a pass, which ends the replay there)."""
    import torch

    from sayuri_tpu_torch.game.state import GoEnv

    rng = np.random.RandomState(seed)
    env = GoEnv(n=n)
    path.mkdir(parents=True, exist_ok=True)
    files = []
    for g in range(games):
        s = env.new_batch(1, komi=7.0, device="cpu")
        played = []
        for t in range(moves):
            legal = np.nonzero(env.legal_action_mask(s)[0, :n * n].numpy())[0]
            v = None if (g == 2 and t == moves - 4) or not len(legal) else int(rng.choice(legal))
            played.append((t % 2, v))
            s = env.step(s, torch.tensor([n * n if v is None else v], dtype=torch.int32))
        f = path / f"g{g}.sgf"
        f.write_text(SGF.game_to_sgf(n, 7.0, played))
        files.append(f)
    return files


@pytest.mark.parametrize("dist,min_count", [(3, 0), (2, 2)])
def test_train_from_sgfs_byte_identical(tmp_path, dist, min_count):
    files = write_sgfs(tmp_path / "sgf", seed=dist)
    want = JGM.train_from_sgfs(files, dist=dist, min_count=min_count, mm_iterations=8)
    got = TGM.train_from_sgfs(files, dist=dist, min_count=min_count, mm_iterations=8,
                              device="cpu")
    want.save(tmp_path / "jax.json")
    got.save(tmp_path / "port.json")
    assert len(got) > 10
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
