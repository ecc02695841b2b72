"""Opening book: position-hash -> move-frequency map built from SGFs
(PyTorch port of sayuri_tpu.game.book).

Built from a directory of SGF games (19x19 only, the first 30 moves, a
move kept when seen at least 5 times) and probed before the search (a hit
returns the book move at once). Storage is a plain JSON file
{hash_hex: {move: count}} with the JAX package's keys, so a book written by
one package loads in the other; probing picks the most frequent legal
move. The games are replayed through the port's GoEnv, one game a batch
of one.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import torch

BOOK_BOARD_SIZE = 19
MAX_BOOK_MOVES = 30
MIN_FREQUENCY = 5


def _hash_key(state) -> str:
    """Book key of a batch-of-one GoState: the two 32-bit hash words in
    hex and the side to move."""
    h = state.hash.reshape(-1).tolist()
    return f"{int(h[0]):08x}{int(h[1]):08x}-{int(state.to_move.reshape(-1)[0])}"


class Book:
    def __init__(self, table: dict | None = None):
        self.table = table or {}

    # -- generation --

    @classmethod
    def generate(cls, sgf_paths, verbose=False, device="cuda"):
        from sayuri_tpu_torch.game import sgf as SGF
        from sayuri_tpu_torch.game.state import GoEnv

        env = GoEnv(n=BOOK_BOARD_SIZE)
        counts: dict[str, dict[int, int]] = defaultdict(lambda: defaultdict(int))
        n_games = 0
        for path in sgf_paths:
            try:
                games = SGF.parse_file(str(path))
            except OSError:
                continue
            for game in games:
                if game.board_size() != BOOK_BOARD_SIZE:
                    continue
                if game.handicap_stones():
                    continue
                state = env.new_batch(1, komi=game.komi(), device=device)
                for i, (color, vertex) in enumerate(game.moves()):
                    if i >= MAX_BOOK_MOVES or vertex is None:
                        break
                    if int(state.to_move[0]) != color:
                        break
                    counts[_hash_key(state)][int(vertex)] += 1
                    state = env.step(state, torch.tensor([vertex], dtype=torch.int32))
                n_games += 1
        table = {}
        for key, moves in counts.items():
            kept = {str(mv): c for mv, c in moves.items() if c >= MIN_FREQUENCY}
            if kept:
                table[key] = kept
        if verbose:
            print(f"book: {n_games} games -> {len(table)} positions")
        return cls(table)

    # -- persistence --

    def save(self, path):
        Path(path).write_text(json.dumps(self.table))

    @classmethod
    def load(cls, path):
        return cls(json.loads(Path(path).read_text()))

    # -- probing --

    def probe(self, state, legal_mask=None) -> int | None:
        """Most frequent legal book move for a batch-of-one `state`, or
        None. `legal_mask`: [A] bools (numpy or a list)."""
        if int(state.size.reshape(-1)[0]) != BOOK_BOARD_SIZE:
            return None
        moves = self.table.get(_hash_key(state))
        if not moves:
            return None
        order = sorted(moves.items(), key=lambda kv: -kv[1])
        for mv, _cnt in order:
            mv = int(mv)
            if legal_mask is None or bool(legal_mask[mv]):
                return mv
        return None

    def __len__(self):
        return len(self.table)
