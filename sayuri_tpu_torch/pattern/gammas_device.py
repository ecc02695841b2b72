"""Device-side pattern-gammas policy for the mix at every expansion
(PyTorch port of sayuri_tpu/pattern/gammas_jax.py).

The pattern-gammas policy is mixed into the net's policy at every node
expansion:

    p[v] = (1-f) * nn[v] + f * (1 - pass_prob) * gammas_policy[v]

with the gammas policy computed per position from spatial pattern keys and
tactical features, scaled by the net's ownership through Pachi's MC-owner
table. ``GammasDict.policy`` (pattern/gammas.py) does this on the host, a
dict probe per vertex; this module does it for a [B] batch of boards with
a few tensor operations each:

- canonical spatial keys: one gather of every vertex's diamond
  neighbourhood out of the board's cell codes padded by `dist` (a
  [n*n, m] index), then the eight symmetries' base-4 packings as one
  float64 product with a [m, 8] matrix of powers of 4 (each symmetry
  permutes the digits, ``_sym_perms``; the values stay below 2**53, so
  the product is exact), and the min over the eight: the host
  ``pattern.pattern_key`` at every dist, as one int64 (a dist-3 key is 52
  bits);
- the dict lookup is a binary search (``torch.searchsorted``) in the
  compiled table's sorted keys, a miss gamma 1.0: the host
  ``table.get(key, 1.0)``. The JAX package's open-addressed table with a
  16-slot probe and its (hi, lo) uint32 lanes is not copied: its keys are
  split as if every key had 24 digits, so at dist 1 and 2 its table keys
  and probe keys disagree and most lookups miss;
- tactical features (dist-to-last-move, adjacent atari / 2-libs chains)
  come from the chain-liberty map that the analysis kernel already
  produced for the encoder, read at each vertex's four neighbours.

The evaluator caches its results after the mix (the mixed policy is a
function of the position), as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sayuri_tpu_torch.pattern import pattern as P
from sayuri_tpu_torch.pattern.gammas import GammasDict

_OFFBOARD = 3  # cell code for off-board, pattern.py _cell_code
_MAX_DIST = 3  # 24 base-4 digits: a key of 52 bits

_TACT4 = (
    "own_atari_adjacent",
    "own_2libs_adjacent",
    "opp_atari_adjacent",
    "opp_2libs_adjacent",
)
# the four neighbours, in the diamond's offsets
_NBRS = ((-1, 0), (0, -1), (0, 1), (1, 0))


class DeviceGammas:
    """GammasDict compiled to tensors: the spatial keys sorted (int64)
    with their gammas, and the tactical gamma vectors."""

    def __init__(self, keys, vals, tact_dist, tact4, dist: int = 3):
        self.keys = keys            # [K] int64, sorted
        self.vals = vals            # [K] f32
        self.tact_dist = tact_dist  # [6]: gamma for dist_last 0..4, [5] = 1
        self.tact4 = tact4          # [4]: _TACT4 order
        self.dist = dist

    @classmethod
    def compile(cls, gd: GammasDict, device="cuda") -> "DeviceGammas":
        if gd.dist > _MAX_DIST:
            raise ValueError(
                "device gammas support pattern dist <= 3 (24 base-4 digits"
                " a key); host GammasDict handles larger"
            )
        spatial = {}
        tact_dist = np.ones(6, np.float32)
        tact4 = np.ones(4, np.float32)
        for k, g in gd.table.items():
            if k.startswith("dist_last:"):
                d = int(k.split(":")[1])
                if 0 <= d <= 4:
                    tact_dist[d] = g
            elif k in _TACT4:
                tact4[_TACT4.index(k)] = g
            else:
                spatial[int(k)] = g
        order = sorted(spatial)
        return cls(
            torch.tensor(order, dtype=torch.int64, device=device),
            torch.tensor([spatial[k] for k in order], dtype=torch.float32, device=device),
            torch.from_numpy(tact_dist).to(device),
            torch.from_numpy(tact4).to(device),
            dist=gd.dist,
        )

    def lookup(self, keys):
        """Gamma for each int64 key, 1.0 on a miss."""
        if not self.keys.numel():
            return torch.ones(keys.shape, dtype=torch.float32, device=keys.device)
        idx = torch.searchsorted(self.keys, keys).clamp(max=self.keys.numel() - 1)
        return torch.where(self.keys[idx] == keys, self.vals[idx], 1.0)


def _sym_perms(dist: int) -> np.ndarray:
    """[8, m] index permutations: perm[s][j] = which neighbour the j-th
    base-4 digit reads under symmetry s (pattern.py _SYMS order)."""
    offs = P.diamond_offsets(dist)
    index = {o: i for i, o in enumerate(offs)}
    return np.array(
        [[index[sym(dy, dx)] for (dy, dx) in offs] for sym in P._SYMS],
        np.int64,
    )


@functools.lru_cache(maxsize=None)
def _key_tables(n: int, dist: int, device: str):
    """([n*n, m] int64 flat index, into the board padded by `dist`, of each
    vertex's diamond neighbours; [m, 8] float64 weights: a symmetry's key
    times 16 is the codes' dot product with its column; [4] the columns of
    the four neighbours)."""
    offs = P.diamond_offsets(dist)
    m, p = len(offs), n + 2 * dist
    y, x = np.divmod(np.arange(n * n), n)
    dy, dx = np.array(offs).T
    nbr = (y[:, None] + dist + dy[None]) * p + (x[:, None] + dist + dx[None])
    w = np.zeros((m, 8), np.float64)
    for s, perm in enumerate(_sym_perms(dist)):
        w[perm, s] = 16.0 * 4.0 ** np.arange(m - 1, -1, -1)
    four = [offs.index(d) for d in _NBRS]
    return (torch.from_numpy(nbr).to(device), torch.from_numpy(w).to(device),
            torch.tensor(four, device=device))


@functools.lru_cache(maxsize=None)
def _board_tables(n: int, device: str):
    """Lookup tables of an n x n buffer on `device`: the cell code of
    [to_move, stone] (0 empty, 1 own, 2 opp); [n*n + 1, n*n] the
    dist_last index of each vertex for each last move (row n*n: none or a
    pass; index 5: no feature); the _TACT4 index of a neighbour's code * 4
    + min(its liberties, 3) (4: none); Pachi's MC-owner gammas."""
    code = torch.tensor([[0, 1, 2], [0, 2, 1]], device=device)
    y, x = np.divmod(np.arange(n * n), n)
    d = np.abs(y[:, None] - y[None]) + np.abs(x[:, None] - x[None])
    dist = np.vstack([np.minimum(d, 5), np.full((1, n * n), 5)])
    tact = np.full(16, 4)
    tact[[1 * 4 + 1, 1 * 4 + 2, 2 * 4 + 1, 2 * 4 + 2]] = range(4)
    owner = torch.tensor(GammasDict.MC_OWNER_GAMMAS, dtype=torch.float32, device=device)
    return (code, torch.from_numpy(dist).to(device), torch.from_numpy(tact).to(device), owner)


def _neighbourhoods(stones, size, to_move, dist):
    """[B, n*n, m] cell codes (0 empty, 1 own, 2 opp, 3 off-board) of
    every vertex's diamond neighbourhood."""
    b, n = stones.shape[0], stones.shape[-1]
    nbr, _, _ = _key_tables(n, dist, str(stones.device))
    lut = _board_tables(n, str(stones.device))[0]
    code = lut[to_move.long()[:, None, None], stones.long()]
    inb = torch.arange(n, device=stones.device) < size[:, None]
    code = torch.where(inb[:, :, None] & inb[:, None, :], code, _OFFBOARD)
    pad = F.pad(code, (dist,) * 4, value=_OFFBOARD)
    return pad.reshape(b, -1)[:, nbr]


def _keys_of(codes, n, dist):
    """[B, n*n] int64 canonical keys of [B, n*n, m] neighbourhood codes:
    16 x (the min of the symmetries' packings) + dist."""
    _, w, _ = _key_tables(n, dist, str(codes.device))
    return ((codes.to(torch.float64) @ w).amin(-1) + dist).to(torch.int64)


def spatial_keys_batch(stones, size, to_move, dist: int = 3):
    """Canonical pattern keys for every vertex: [B, n, n] int64, equal to
    pattern.pattern_key: base-4 pack of the dist-diamond neighbourhood
    (0 empty / 1 own / 2 opp / 3 off-board), min over the 8 dihedral
    symmetries, (key << 4) | dist."""
    b, n = stones.shape[0], stones.shape[-1]
    codes = _neighbourhoods(stones, size, to_move, dist)
    return _keys_of(codes, n, dist).view(b, n, n)


def gammas_policy_device(
    dev: DeviceGammas,
    stones,       # [B, n, n] int8
    size,         # [B] int32
    to_move,      # [B] int32
    legal_board,  # [B, n*n] bool
    last_move,    # [B] int32 flat vertex, -1 none/pass
    libs,         # [B, n, n] per-chain liberty counts (0 on empty)
    ownership=None,  # [B, n*n] to-move perspective in [-1, 1]
):
    """[B, n*n] normalized gammas policy: GammasDict.policy for a batch."""
    b, n = stones.shape[0], stones.shape[-1]
    d0 = stones.device
    _, dist_idx, tact_idx, owner = _board_tables(n, str(d0))
    codes = _neighbourhoods(stones, size, to_move, dev.dist)
    g = dev.lookup(_keys_of(codes, n, dev.dist))          # [B, n*n]

    # dist-to-last-move feature ("dist_last:d", d <= 4)
    last = torch.where(last_move >= 0, last_move.long(), n * n)
    g = g * dev.tact_dist[dist_idx[last]]

    # adjacent-chain tacticals from the liberty map: a feature fires once
    # if ANY neighbour matches (code 1 own / 2 opp, 1 or 2 liberties)
    _, _, four = _key_tables(n, dev.dist, str(d0))
    nbr1, _, _ = _key_tables(n, 1, str(d0))               # [n*n, 4] in _NBRS order
    lib4 = F.pad(libs.long().clamp(max=3), (1, 1, 1, 1)).reshape(b, -1)[:, nbr1]
    feat = tact_idx[codes[:, :, four] * 4 + lib4]         # [B, n*n, 4]
    present = torch.zeros((b, n * n, 5), dtype=torch.bool, device=d0)
    present.scatter_(2, feat, True)
    g = g * torch.where(present[..., :4], dev.tact4, 1.0).prod(-1)

    if ownership is not None:
        # the bucket int((o + 1) / 2 * 8) within [0, 7]
        g = g * owner[((ownership + 1.0) * 4.0).long().clamp(0, 7)]

    g = torch.where(legal_board, g, 0.0)
    total = g.sum(-1, keepdim=True)
    uniform = legal_board.to(torch.float32)
    uniform = uniform / uniform.sum(-1, keepdim=True).clamp(min=1.0)
    return torch.where(total > 0, g / total.clamp(min=1e-30), uniform)


def libs_map_batch(stones):
    """[B, n, n] int32 per-chain liberty counts (both colors; 0 on empty)
    from one chain-labels launch over both colors' masks: the liberty map
    of an evaluator that has no analysis kernel's."""
    from sayuri_tpu_torch.game import board as B

    masks = torch.stack([stones == 1, stones == 2])       # [2, B, n, n]
    labels = B.chain_labels(masks)
    libs = B.chain_liberty_map(masks, labels, (stones == 0)[None])
    return libs.sum(0).to(torch.int32)


def mix_gammas_priors(factor, priors, g):
    """Board cells get (1-f)*nn + f*(1-pass)*gammas; the pass probability
    is left untouched (the mixed row still sums to 1 because the gammas
    policy itself sums to 1 over board cells)."""
    nn_board, nn_pass = priors[:, :-1], priors[:, -1:]
    board = (1.0 - factor) * nn_board + factor * (1.0 - nn_pass) * g
    return torch.cat([board, nn_pass], -1)


def apply_to_evals(dev, factor, states, evals, legal, libs=None):
    """Mix the device gammas policy into a NetEvals batch (the
    per-expansion hook shared by the real and weightless evaluators)."""
    n = states.stones.shape[-1]
    if libs is None:
        libs = libs_map_batch(states.stones)
    stm_sign = torch.where(states.to_move == 0, 1.0, -1.0)
    g = gammas_policy_device(
        dev,
        states.stones,
        states.size,
        states.to_move,
        legal[:, : n * n],
        states.last_moves[:, 0],
        libs,
        ownership=evals.black_ownership * stm_sign[:, None],
    )
    pri = mix_gammas_priors(factor, evals.priors, g)
    pri = torch.where(legal, pri, 0.0)
    pri = pri / pri.sum(-1, keepdim=True).clamp(min=1e-12)
    return evals._replace(priors=pri)


def wrap_eval_with_gammas(env, eval_fn, dev: DeviceGammas, factor: float):
    """Wrap any eval_fn with per-expansion gammas mixing (the weightless
    path; the net's evaluator applies the mix inline to reuse the analysis
    kernel's liberty map)."""

    def wrapped(states, ctx=None):
        evals = eval_fn(states, ctx)
        legal = env.legal_action_mask(states)
        return apply_to_evals(dev, factor, states, evals, legal)

    return wrapped
