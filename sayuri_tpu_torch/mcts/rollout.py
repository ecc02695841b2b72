"""Monte-Carlo rollout ownership (PyTorch port of sayuri_tpu.mcts.rollout):
with ``--use-rollout`` the evaluator's ownership map is replaced by the
ownership at the end of ONE random playout from the evaluated position.

The playout policy is batched mask arithmetic, with no per-lane Python:
prioritized move classes taken with probability 0.9 each, in order:
capture, atari, escape (the last two skipping self-atari), else a uniform
legal move that does not fill a simple eye. The JAX package folds the
reference's pattern3 tier into the uniform one; so does the port.

Tactical predicates (per board, batched over [B]):
- capture:    empty point next to an opponent chain in atari
- atari:      legal point next to an opponent chain with two liberties
- escape:     legal point next to an own chain in atari
- self-atari: |union of the merged chains' liberties| + pseudo-liberties
  == 1; the union is a 0/1 matrix product over chain-root slots
  ([B, nn, nn] bmm), which the JAX package also leaves to a plain matmul.

On the card the labels run as one labels-kernel launch per call, the steps
as the step+analysis kernel (``GoEnv.step_batch_with_analysis``, as the JAX
package steps its playouts) and the final ownership as one flood launch.
Random numbers come from a ``torch.Generator``; they differ from the JAX
package's threefry draws.
"""

from __future__ import annotations

import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.state import GoEnv, GoState
from sayuri_tpu_torch.game.types import EMPTY

# lanes are checked for all-terminated every this many playout moves (one
# host sync); a frozen batch changes no more, so stopping there gives the
# same result as playing on to the cap
_DONE_CHECK = 32


def tactical_masks(stones, size, legal, to_move):
    """[B, nn] bool masks {capture, atari, escape, self_atari, simple_eye}
    for `to_move` ([B]) on [B, n, n] boards; `legal` is [B, n, n] bool."""
    b, n = stones.shape[0], stones.shape[-1]
    nn = n * n
    dev = stones.device
    mask = B.board_mask(size, n, dev)
    tm = to_move.to(torch.int64)[:, None, None]
    empty = (stones == EMPTY) & mask
    own = (stones == tm + 1) & mask
    opp = (stones == 2 - tm) & mask

    lbl_own, lbl_opp = B.chain_labels(torch.stack([own, opp]))
    libs_own = B.chain_liberty_counts(lbl_own, empty)      # [B, nn]
    libs_opp = B.chain_liberty_counts(lbl_opp, empty)

    def nbr_libs(lbl, libs):
        """([B, 4, n, n] neighbour chain roots, their liberty counts)."""
        nbr = B.neighbor_labels(lbl)
        cnt = libs.gather(1, nbr.clamp(min=0).reshape(b, 4 * nn))
        return nbr, cnt.reshape(nbr.shape)

    nbr_opp, libs_nb_opp = nbr_libs(lbl_opp, libs_opp)
    nbr_own, libs_nb_own = nbr_libs(lbl_own, libs_own)
    capture = empty & ((nbr_opp >= 0) & (libs_nb_opp == 1)).any(1)
    atari = legal & ((nbr_opp >= 0) & (libs_nb_opp == 2)).any(1)
    escape = legal & ((nbr_own >= 0) & (libs_nb_own == 1)).any(1)

    # simple eye: every orthogonal neighbour own or off the board
    orth_ok = torch.ones_like(own)
    for d in B._DIRS:
        orth_ok &= B.shift(own, *d, False) | ~B.shift(mask, *d, False)
    simple_eye = empty & orth_ok

    # self-atari: empty orthogonal neighbours + one per adjacent opponent
    # chain in atari (capture credit) + the merged own chains' liberties
    pseudo = B.nbr_count(empty)
    cap_credit = ((nbr_opp >= 0) & (libs_nb_opp <= 1)).sum(1)
    # adj[v, c]: own chain c is next to v; lib_inc[c, u]: u is a liberty of c
    adj = torch.zeros((b, nn, nn + 1), device=dev)
    for d in range(4):
        c = nbr_own[:, d].reshape(b, nn)
        adj.scatter_(2, torch.where(c >= 0, c, nn)[:, :, None], 1.0)
    lib_inc = torch.zeros((b, nn + 1, nn), device=dev)
    for d in range(4):
        c = torch.where(empty, nbr_own[:, d], -1).reshape(b, nn)
        lib_inc.scatter_(1, torch.where(c >= 0, c, nn)[:, None, :], 1.0)
    merged = torch.bmm(adj[:, :, :nn], lib_inc[:, :nn]) > 0.5   # [B, v, u]
    merged &= ~torch.eye(nn, dtype=torch.bool, device=dev)
    potential = merged.sum(-1).reshape(b, n, n)
    self_atari = legal & ((potential + pseudo + cap_credit) == 1)

    return {
        "capture": (capture & legal).reshape(b, nn),
        "atari": atari.reshape(b, nn),
        "escape": escape.reshape(b, nn),
        "self_atari": self_atari.reshape(b, nn),
        "simple_eye": simple_eye.reshape(b, nn),
    }


def move_tiers(env: GoEnv, states: GoState):
    """[B, 4, nn] bool move classes in priority order: capture, atari and
    escape without self-atari, then the legal moves that fill no simple
    eye (unless they capture or escape)."""
    nn = env.n * env.n
    b = states.stones.shape[0]
    legal = env.legal_action_mask(states)[:, :nn]
    m = tactical_masks(states.stones, states.size,
                       legal.reshape(states.stones.shape), states.to_move)
    no_sa = ~m["self_atari"]
    uniform = legal & ~(m["simple_eye"] & ~m["capture"] & ~m["escape"])
    return torch.stack(
        [m["capture"], m["atari"] & no_sa, m["escape"] & no_sa, uniform], 1
    ).reshape(b, 4, nn)


def random_move_batch(env: GoEnv, states: GoState, gen: torch.Generator):
    """[B] int32 prioritized random move per lane: the first usable tier
    (each of the first three wanted with probability 0.9), then a uniform
    move of that tier; pass where none is left or the game is over."""
    nn = env.n * env.n
    b = states.stones.shape[0]
    dev = states.stones.device
    tiers = move_tiers(env, states)
    roll = torch.rand((b, 3), generator=gen, device=dev)
    usable = tiers.any(-1)                                   # [B, 4]
    take = torch.cat([(roll < 0.9) & usable[:, :3], usable[:, 3:]], 1)
    tier = take.to(torch.uint8).argmax(1)                    # first usable
    chosen = tiers.gather(1, tier[:, None, None].expand(b, 1, nn))[:, 0]
    keys = torch.rand((b, nn), generator=gen, device=dev)
    mv = torch.where(chosen, keys, -1.0).argmax(1)
    mv = torch.where(chosen.any(-1) & ~states.terminated, mv, nn)
    return mv.to(torch.int32)


def mc_ownership(env: GoEnv, states: GoState, gen: torch.Generator,
                 max_moves=None):
    """([B, nn] float32 ownership in {-1, 0, +1}, [B] black score) at the
    end of ONE random playout per lane of at most `max_moves` moves
    (default 2*nn + 1)."""
    nn = env.n * env.n
    cap = max_moves if max_moves is not None else 2 * nn + 1
    st = states
    for i in range(cap):
        if i % _DONE_CHECK == 0 and i and bool(st.terminated.all()):
            break
        mv = random_move_batch(env, st, gen)
        st, _ = env.step_batch_with_analysis(st, mv)
    own = B.area_ownership(st.stones, st.size)
    own = own.reshape(own.shape[0], -1).to(torch.float32)
    score = own.sum(-1) - env.komi_with_penalty(states)
    return own, score


def wrap_eval_with_rollout(env: GoEnv, base_eval_fn, max_moves=None):
    """Evaluator wrapper: the base evaluator's black_ownership replaced by
    the rollout ownership. The generator is seeded from the positions'
    hashes (one host read per call), so searches stay deterministic."""

    def eval_fn(states: GoState, ctx=None):
        evals = base_eval_fn(states, ctx)
        seed = int(states.hash[:, 0].sum()) & 0xFFFFFFFF
        gen = torch.Generator(device=states.stones.device)
        gen.manual_seed(seed)
        own, _ = mc_ownership(env, states, gen, max_moves=max_moves)
        return evals._replace(black_ownership=own)

    return eval_fn
