"""The midgame-root generator: for each lane a move count drawn uniformly
from 0 to `max_moves`, then that many uniformly random legal board moves
(no suicide, simple ko) from the empty board, all lanes at once with the
frozen plain rules. A lane whose move would repeat an earlier position
(positional superko) stops before it. Deterministic in the seed: the draws
have the same shapes whatever the boards hold."""

from __future__ import annotations

import torch

from port_bench.reference import rules as RU


def midgame(batch: int, seed: int, device, max_moves: int = 200, n: int = 19):
    """([batch, max_moves] int64 moves, -1 past each lane's end; [batch]
    int64 move counts)."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    target = torch.randint(0, max_moves + 1, (batch,), generator=g, device=device)
    s = RU.empty(batch, n, RU.AREA, 7.5, device)
    moves = torch.full((batch, max_moves), -1, dtype=torch.int64, device=device)
    alive = torch.ones((batch,), dtype=torch.bool, device=device)
    seen = [s.hash()]
    for t in range(max_moves):
        u = torch.rand((batch, n * n), generator=g, device=device)
        go = alive & (t < target)
        if not bool(go.any()):
            break
        legal = RU.legal_board(s)
        a = torch.where(legal, u, -1.0).argmax(-1)
        go = go & legal.any(-1)
        s2, _ = RU.play(s, a, keep=go)
        h = s2.hash()
        repeat = (h[:, None] == torch.stack(seen, 1)).all(-1).any(-1)
        go = go & ~repeat
        alive = go
        s = RU.RefState(**{k: torch.where(go.view((-1,) + (1,) * (v.ndim - 1)), v, getattr(s, k))
                           for k, v in vars(s2).items()})
        seen.append(s.hash())
        moves[:, t] = torch.where(go, a, -1)
    return moves, (moves >= 0).sum(1)
