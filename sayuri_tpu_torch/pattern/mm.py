"""Minorization-Maximization gamma fitting.

The port's own copy of sayuri_tpu.pattern.mm (pure Python). Remi
Coulom's MM algorithm for generalized Bradley-Terry models of move
selection: each competition is one observed move choice among legal
candidates; each candidate's strength is the product of its feature
gammas; the MM update for feature f is

    gamma_f  <-  W_f / sum_competitions( C_f / E )

where W_f = wins of f (appearances in chosen teams), C_f = sum of team
strengths (excluding gamma_f) of candidates containing f, and E = total
strength of the competition.
"""

from __future__ import annotations

import math
from collections import defaultdict


def fit_mm(competitions, iterations: int = 30, verbose=False):
    """competitions: list of (winner_idx, teams) where teams is a list of
    feature-id tuples (one per candidate). Returns {feature: gamma}."""
    gammas: dict = defaultdict(lambda: 1.0)
    wins: dict = defaultdict(float)
    for winner, teams in competitions:
        for f in teams[winner]:
            wins[f] += 1.0

    for it in range(iterations):
        num = defaultdict(float)  # sum of C_f / E per feature
        loglik = 0.0
        for winner, teams in competitions:
            strengths = []
            for team in teams:
                s = 1.0
                for f in team:
                    s *= gammas[f]
                strengths.append(s)
            e = sum(strengths)
            if e <= 0:
                continue
            loglik += math.log(max(strengths[winner] / e, 1e-300))
            for team, s in zip(teams, strengths):
                for f in team:
                    num[f] += (s / gammas[f]) / e
        changed = 0.0
        for f, w in wins.items():
            if num[f] > 0:
                new = w / num[f]
                changed = max(changed, abs(math.log(max(new, 1e-12) / gammas[f])))
                gammas[f] = new
        if verbose:
            print(f"mm iter {it}: loglik={loglik:.1f} max_dlog={changed:.4f}")
        if changed < 1e-4:
            break
    return dict(gammas)
