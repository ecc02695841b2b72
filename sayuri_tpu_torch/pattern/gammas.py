"""Gammas dictionary, policy hook and SGF trainer (PyTorch port of
sayuri_tpu.pattern.gammas).

The gammas are trained from SGFs, saved as JSON, and their normalized
policy is mixed into the search policy through gammas_policy_factor.
``GammasDict`` is a copy of the JAX package's; ``train_from_sgfs`` replays
the games through the port's env and builds the competitions in the JAX
package's order, so MM's floats, and the saved file, come out the same.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from sayuri_tpu_torch.pattern import pattern as P
from sayuri_tpu_torch.pattern.mm import fit_mm


class GammasDict:
    def __init__(self, table: dict | None = None, dist: int = 3):
        self.table = table or {}
        self.dist = dist

    def __len__(self):
        return len(self.table)

    def save(self, path):
        Path(path).write_text(
            json.dumps({"dist": self.dist, "gammas": self.table})
        )

    @classmethod
    def load(cls, path):
        blob = json.loads(Path(path).read_text())
        return cls(blob["gammas"], blob.get("dist", 3))

    def team_strength(self, features) -> float:
        s = 1.0
        for f in features:
            s *= self.table.get(str(f), 1.0)
        return s

    # Pachi's MC-owner gamma table
    MC_OWNER_GAMMAS = (
        0.130817, 0.67241, 1.0993, 1.22413,
        1.18569, 1.05496, 0.800636, 0.406365,
    )

    def policy(self, board: np.ndarray, size: int, to_move: int,
               legal_mask, last_move=None, ownership=None) -> np.ndarray:
        """[size*size + 1] normalized gammas policy. `ownership`
        ([size*size] in [-1, 1], to-move perspective) scales each point's
        gamma by the Pachi MC-owner table. Restricted to legal moves."""
        out = np.zeros(size * size + 1)
        libs = P.chain_liberty_counts(board, size)
        for v in range(size * size):
            if not legal_mask[v]:
                continue
            feats = [P.pattern_key(board, size, v, to_move, self.dist)]
            feats += P.tactical_features(board, size, v, to_move, last_move,
                                         libs=libs)
            g = self.team_strength(feats)
            if ownership is not None:
                owner = (float(ownership[v]) + 1.0) / 2.0
                g *= self.MC_OWNER_GAMMAS[min(7, int(owner * 8))]
            out[v] = g
        total = out.sum()
        if total <= 0:
            out[: size * size] = np.asarray(legal_mask[: size * size], float)
            total = max(out.sum(), 1.0)
        return out / total


def train_from_sgfs(sgf_paths, dist: int = 3, max_games: int | None = None,
                    mm_iterations: int = 30, verbose=False,
                    min_count: int = 0, device="cuda") -> GammasDict:
    """Collect (chosen move vs candidates) competitions from SGF games and
    fit gammas. Candidates are all legal moves; features = canonical
    spatial pattern + tacticals. `min_count` drops spatial patterns seen
    fewer times as a WINNER. The games are replayed one move at a time
    through the port's env on `device` (a batch of one)."""
    import torch

    from sayuri_tpu_torch.game import sgf as SGF
    from sayuri_tpu_torch.game.state import GoEnv

    competitions = []
    n_games = 0
    envs = {}
    for path in sgf_paths:
        try:
            games = SGF.parse_file(str(path))
        except OSError:
            continue
        for game in games:
            size = game.board_size()
            env = envs.setdefault(size, GoEnv(n=size))
            state = env.new_batch(1, komi=game.komi(), device=device)
            last = None
            for color, vertex in game.moves():
                if vertex is None:
                    break
                if int(state.to_move[0]) != color:
                    break
                board = state.stones[0].cpu().numpy()
                legal = env.legal_action_mask(state)[0].cpu().numpy()
                cands = [v for v in range(size * size) if legal[v]]
                if vertex in cands and len(cands) > 1:
                    teams = []
                    widx = None
                    libs = P.chain_liberty_counts(board, size)
                    for i, v in enumerate(cands):
                        feats = [
                            P.pattern_key(board, size, v, color, dist)
                        ] + P.tactical_features(board, size, v, color, last,
                                                libs=libs)
                        teams.append(tuple(str(f) for f in feats))
                        if v == vertex:
                            widx = i
                    competitions.append((widx, teams))
                state = env.step(state, torch.tensor([vertex], dtype=torch.int32,
                                                     device=state.stones.device))
                last = vertex
            n_games += 1
            if max_games and n_games >= max_games:
                break
        if max_games and n_games >= max_games:
            break
    if verbose:
        print(f"patterns: {n_games} games, {len(competitions)} competitions")
    if min_count > 0:
        winner_counts: dict[str, int] = {}
        for widx, teams in competitions:
            for f in teams[widx]:
                winner_counts[f] = winner_counts.get(f, 0) + 1
        competitions = [
            (widx, teams)
            for widx, teams in competitions
            if all(winner_counts.get(f, 0) >= min_count for f in teams[widx])
        ]
    gammas = fit_mm(competitions, iterations=mm_iterations, verbose=verbose)
    return GammasDict({str(k): v for k, v in gammas.items()}, dist)
