"""Test positions for the board kernels: random legal games and boards
built to stress the labelling (one long snake chain, many one-stone
chains, full and empty boards, small games in a larger buffer).

Every function returns CPU tensors made from a seed with numpy, so that
the CPU tests, the shim runs and chip_smoke.py see the same boards.
"""

from __future__ import annotations

import numpy as np
import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.state import GoEnv


def random_positions(n: int, b: int, seed: int, max_moves: int, size=None, device="cpu"):
    """Legal random games on an n x n buffer (games of `size` when given),
    played by the env on `device` (the plain env on the CPU, the kernels on
    the card: the same legal moves, so the same games); each lane stops
    after its own number of moves. Returns (states, actions) on the CPU,
    with one legal next action per lane (some passes)."""
    env = GoEnv(n=n)
    rng = np.random.RandomState(seed)
    s = env.new_batch(b, size=size, device=device)
    stop = rng.randint(0, max_moves, size=b)
    for m in range(max_moves):
        legal = env.legal_action_mask(s).cpu().numpy()
        acts = np.array([
            rng.choice(np.nonzero(l[:-1])[0])
            if l[:-1].any() and m < stop[i] else n * n
            for i, l in enumerate(legal)
        ], np.int32)
        s = env.step(s, torch.from_numpy(acts).to(device))
        # keep lanes alive: passes here only mark a lane as finished
        s = s.replace(terminated=torch.zeros_like(s.terminated),
                      pass_count=torch.zeros_like(s.pass_count))
    legal = env.legal_action_mask(s).cpu().numpy()
    acts = np.array([rng.choice(np.nonzero(l)[0]) for l in legal], np.int32)
    return s.to("cpu"), torch.from_numpy(acts)


def spiral(n: int) -> np.ndarray:
    """[n, n] bool: one snake from the corner (0, 0) winding inwards, with
    one empty line between its turns (about n * n / 2 cells)."""
    m = np.zeros((n, n), bool)
    y, x, d = 0, 0, 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))

    def stone(yy, xx):
        return 0 <= yy < n and 0 <= xx < n and m[yy, xx]

    m[0, 0] = True
    turns = 0
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx = y + dy, x + dx
        free = (0 <= ny < n and 0 <= nx < n and not m[ny, nx]
                and not stone(ny + dy, nx + dx)
                and not stone(ny + dx, nx + dy) and not stone(ny - dx, nx - dy))
        if free:
            y, x = ny, nx
            m[y, x] = True
            turns = 0
        else:
            d = (d + 1) % 4
            turns += 1
    return m


def stress_positions(n: int = 19, seed: int = 0):
    """Boards that stress the labelling, on an n x n buffer. Returns
    (stones [B, n, n] int8, size, ko, to_move, action [B] int32, names):
    a one-colour spiral of each colour (one snake chain), a one-colour
    checkerboard (one-stone chains), the full board of each colour, the
    empty board, the spiral with every gap cell but one taken by the other
    colour (the move there captures a whole snake), and two random games
    on smaller boards in the buffer (sizes n - 10 and n - 6, or 5 and 7 on
    a 9 x 9 buffer). Each board comes with either side to move; the action
    is the capture move on the double spiral, else a legal move drawn from
    `seed` (a pass where none is legal)."""
    rng = np.random.RandomState(seed)
    nn = n * n
    sp = spiral(n)
    yy, xx = np.mgrid[0:n, 0:n]
    gaps = ~sp
    # the gap cell next to the spiral with the highest index stays empty
    nbr_sp = np.zeros_like(sp)
    nbr_sp[1:] |= sp[:-1]
    nbr_sp[:-1] |= sp[1:]
    nbr_sp[:, 1:] |= sp[:, :-1]
    nbr_sp[:, :-1] |= sp[:, 1:]
    hole = int(np.flatnonzero(gaps & nbr_sp).max())
    double = np.where(sp, 1, 2).astype(np.int8)
    double.flat[hole] = 0
    boards = {
        "spiral black": np.where(sp, 1, 0),
        "spiral white": np.where(sp, 2, 0),
        "checkerboard": np.where((yy + xx) % 2 == 0, 1, 0),
        "full black": np.ones((n, n)),
        "full white": np.full((n, n), 2),
        "empty": np.zeros((n, n)),
        "double spiral": double,
    }
    stones, names, sizes, holes = [], [], [], []
    for name, st in boards.items():
        for tm in (0, 1):
            stones.append(torch.from_numpy(st.astype(np.int8)))
            names.append(f"{name}, {'white' if tm else 'black'} to move")
            sizes.append(n)
            holes.append(hole if name == "double spiral" else -1)
    stones = torch.stack(stones)
    size = torch.tensor(sizes, dtype=torch.int32)
    to_move = torch.arange(len(names), dtype=torch.int32) % 2
    ko = torch.full_like(size, -1)
    small = (5, 7) if n <= 9 else (n - 10, n - 6)
    for i, sz in enumerate(small):
        s, _ = random_positions(n, 2, seed + 1 + i, 3 * sz * sz // 2, size=sz)
        stones = torch.cat([stones, s.stones])
        size = torch.cat([size, s.size])
        ko = torch.cat([ko, s.ko])
        to_move = torch.cat([to_move, s.to_move])
        names += [f"{sz}x{sz} game in the {n}x{n} buffer"] * 2
        holes += [-1, -1]
    legal = B.legal_moves(stones, size, to_move, ko, plain=True).numpy()
    action = torch.tensor([
        h if h >= 0 else (rng.choice(np.flatnonzero(l)) if l.any() else nn)
        for h, l in zip(holes, legal)
    ], dtype=torch.int32)
    return stones, size, ko, to_move, action, names
