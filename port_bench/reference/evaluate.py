"""The reference evaluation of positions: planes, the symmetry the program
draws from the position hash, the plain net, and the post-processing the
search reads (legal-masked softmax, pass suppression, black's winrate)."""

from __future__ import annotations

import types

import torch

from port_bench.reference import frozen as R
from port_bench.reference import net as N
from port_bench.reference import rules as RU

# pass leaves the priors while more than (1 - factor) * size^2 board moves
# are legal (the reference engine's default)
SUPPRESS_PASS_FACTOR = 0.1667
BLOCK = 256


def suppress_pass(priors, legal, n):
    n_legal = legal[:, :-1].sum(-1).to(torch.float32)
    keep_pass = ~(n_legal > (1.0 - SUPPRESS_PASS_FACTOR) * float(n * n))
    pri = torch.cat([priors[:, :-1], priors[:, -1:] * keep_pass[:, None]], -1)
    return pri / pri.sum(-1, keepdim=True).clamp(min=1e-12)


def evaluate(cfg, w, s: RU.RefState, ladders, quant=None):
    """(priors [B, A], black winrate [B]) of the positions `s` with the
    root ladder planes `ladders` [B, n, n, 4], in blocks of BLOCK."""
    pri, wl = [], []
    for i in range(0, s.stones.shape[0], BLOCK):
        idx = torch.arange(i, min(i + BLOCK, s.stones.shape[0]), device=s.stones.device)
        p, v = _evaluate(cfg, w, s.take(idx), ladders[idx], quant)
        pri.append(p)
        wl.append(v)
    return torch.cat(pri), torch.cat(wl)


def _evaluate(cfg, w, s, ladders, quant):
    n = s.n
    an = RU.analysis(s)
    planes = RU.encode(s, ladders, an)
    terminated = s.passes >= 2
    board = an["legal"] & ~terminated[:, None]
    legal = torch.cat([board, torch.ones_like(board[:, :1])], -1)
    syms = R.random_symmetries(types.SimpleNamespace(hash=s.hash(), to_move=s.to_move), 0)
    logits, wdl = N.forward(cfg, w, R.transform_planes_batch(planes, syms), quant)
    logits = R.inverse_transform_policy_batch(logits, syms, n)
    priors = torch.where(legal, torch.softmax(torch.where(legal, logits, -torch.inf), -1), 0.0)
    wdl = torch.softmax(wdl, -1)
    stm = (wdl[:, 0] - wdl[:, 2] + 1.0) / 2.0
    black_wl = torch.where(s.to_move == 0, stm, 1.0 - stm)
    return suppress_pass(priors, legal, n), black_wl
