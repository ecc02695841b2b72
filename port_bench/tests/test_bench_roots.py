"""The midgame-root generator: deterministic in the seed, legal, and
within its move counts."""

import torch

from port_bench import roots
from port_bench.reference import check as RC


def test_same_seed_same_roots():
    a = roots.midgame(8, 2**31 + 5, "cpu", max_moves=30)
    b = roots.midgame(8, 2**31 + 5, "cpu", max_moves=30)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_other_seed_other_roots():
    a = roots.midgame(8, 2**31 + 5, "cpu", max_moves=30)
    b = roots.midgame(8, 2**31 + 6, "cpu", max_moves=30)
    assert not torch.equal(a[0], b[0])


def test_roots_are_legal_games():
    moves, counts = roots.midgame(8, 2**33 + 1, "cpu", max_moves=30)
    assert int(counts.max()) <= 30
    assert torch.equal(counts, (moves >= 0).sum(1))
    _, _, illegal = RC.replay(moves, counts, 0, 7.5, "cpu")
    assert illegal == 0
