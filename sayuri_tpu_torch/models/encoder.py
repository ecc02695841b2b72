"""Input-plane encoder (v2, 43 channels), batched PyTorch port of
sayuri_tpu.models.encoder.

  planes  0-23 : 8 history steps x (to-move stones, opponent stones,
                 one-hot last move), most recent first
  plane     24 : ko vertex one-hot
  planes 25-28 : area features, zero under territory rule:
                 [safe & mine, safe & theirs, owner mine, owner theirs]
  planes 29-32 : stones whose chain has exactly 1 / 2 / 3 / 4 liberties
  planes 33-36 : ladder features [death, escapable, atari, take]
  plane     37 : scoring rule (0 area / 1 territory)
  plane     38 : wave (drawable-komi dither)
  plane     39 : komi/20 (komi-with-penalty, negated for white to move)
  plane     40 : -komi/20
  plane     41 : intersections/361
  plane     42 : ones (on-board mask)

Output is NHWC ([B, n, n, 43] float32), as in the JAX package.
"""

from __future__ import annotations

import torch

from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.state import GoEnv, GoState, HISTORY_LEN
from sayuri_tpu_torch.game.types import AREA_RULE, EMPTY

NUM_PLANES = 43


def encode(env: GoEnv, states: GoState, ladder_planes, libs_map, safe_map,
           score_own_map) -> torch.Tensor:
    """[B, n, n, NUM_PLANES] float32 input planes.

    `ladder_planes`: [B, n, n, 4] ladder features (zeros when ladders are
    off). `libs_map` / `safe_map` / `score_own_map`: the [B, n, n] chain
    liberties (capped at >= 4), safe area and score ownership that the
    analysis kernels produce (ops/analysis.py)."""
    n = env.n
    dev = states.stones.device
    f32 = torch.float32
    mask = B.board_mask(states.size, n, dev)             # [B, n, n]
    maskf = mask.to(f32)
    tm = states.to_move.to(torch.int64)[:, None, None]
    own_c = tm + 1
    opp_c = 2 - tm
    flat = B.flat_iota(n, dev)

    planes = []
    past = torch.clamp(states.move_count + 1, max=HISTORY_LEN)
    for p in range(HISTORY_LEN):
        hboard = states.history[:, p] if p > 0 else states.stones
        valid = (p < past).to(f32)[:, None, None]
        own = ((hboard == own_c) & mask).to(f32) * valid
        opp = ((hboard == opp_c) & mask).to(f32) * valid
        mv = states.last_moves[:, p].to(torch.int64)[:, None, None]
        planes += [own, opp, ((flat == mv) & mask).to(f32) * valid]

    ko = states.ko.to(torch.int64)[:, None, None]
    planes.append(((flat == ko) & mask).to(f32))

    is_area = (states.rule == AREA_RULE).to(f32)[:, None, None]
    mine_val = torch.where(tm == 0, 1, -1)
    owner_mine = score_own_map == mine_val
    owner_theirs = score_own_map == -mine_val
    planes.append((safe_map & owner_mine).to(f32) * is_area)
    planes.append((safe_map & owner_theirs).to(f32) * is_area)
    planes.append(owner_mine.to(f32) * is_area)
    planes.append(owner_theirs.to(f32) * is_area)

    stones_any = (states.stones != EMPTY) & mask
    for k in (1, 2, 3, 4):
        planes.append((stones_any & (libs_map == k)).to(f32))

    for k in range(4):
        planes.append(ladder_planes[..., k].to(f32))

    wave = env.wave(states)[:, None, None]
    komi = env.komi_with_penalty(states)
    komi = torch.where(states.to_move == 1, -komi, komi)[:, None, None]
    planes.append(maskf * (states.rule != AREA_RULE).to(f32)[:, None, None])
    planes.append(maskf * wave)
    planes.append(maskf * (komi / 20.0))
    planes.append(maskf * (-komi / 20.0))
    planes.append(maskf * (states.size * states.size).to(f32)[:, None, None] / 361.0)
    planes.append(maskf)
    return torch.stack(planes, -1)
