"""Board step + analysis kernels (CUDA, csrc/analysis.cu) and their plain
PyTorch twins.

Two entry points, each a hand-written CUDA kernel for sm_90a:

- ``step_and_analyze`` replaces the Pallas ``_step_analysis_kernel``
  (sayuri_tpu/ops/analysis.py, entry ``step_and_analyze_tpu``): play the
  move, hash the child, and analyse the child with the side to move
  flipped. It runs once per search simulation.
- ``board_analysis`` replaces the Pallas ``_analysis_kernel`` (entry
  ``board_analysis_tpu``): the same analysis on a position without a move.
  It serves the root evaluation.

The analysis outputs are: legality, per-stone chain liberties capped at 5,
Tromp-Taylor reach ownership, the safe (pass-alive / pass-dead) area of
both colours and the score-area ownership.

A wrapper given CPU tensors computes the plain twin (built from
game/board.py and game/analysis.py); given CUDA tensors it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches per entry point.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sayuri_tpu_torch.game import analysis as GA
from sayuri_tpu_torch.game import board as B
from sayuri_tpu_torch.game.types import C_BLACK, C_WHITE, NO_VERTEX

_NUM_LIBS = 5  # liberty counts are capped here (planes need 1..4 exactly)
MAX_N = 19     # one CUDA thread per cell, 384 threads at most

# kernel launches per entry point (CUDA tensors only; the twins never count)
LAUNCHES = {"step_and_analyze": 0, "board_analysis": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def board_analysis_plain(stones, size, ko, to_move):
    """Plain PyTorch version of the analysis kernel. [B, n, n] int8 stones,
    [B] int32 size/ko/to_move -> dict(legal [B, nn] bool, libs, ownership,
    score_ownership [B, n, n] int32, safe [B, n, n] bool)."""
    n = stones.shape[-1]
    mask = B.board_mask(size, n, stones.device)
    empty = (stones == 0) & mask
    libs = torch.zeros(stones.shape, dtype=torch.int64, device=stones.device)
    for c in (C_BLACK, C_WHITE):
        m = (stones == c) & mask
        libs = libs + B.chain_liberty_map(m, B.chain_labels(m), empty)
    safe, sown = GA.safe_and_ownership(stones, size)
    return {
        "legal": B.legal_moves(stones, size, to_move, ko),
        "libs": libs.clamp(max=_NUM_LIBS).to(torch.int32),
        "ownership": B.area_ownership(stones, size).to(torch.int32),
        "safe": safe,
        "score_ownership": sown.to(torch.int32),
    }


def step_and_analyze_plain(stones, size, ko, to_move, action):
    """Plain PyTorch version of the step+analysis kernel: play `action`
    (>= n*n is a pass), hash the child, analyse it with the side to move
    flipped. Returns the analysis dict plus new_stones [B, n, n] int8,
    n_captured [B] int32, new_ko [B] int32, new_hash [B, 2] int64."""
    nn = stones.shape[-1] ** 2
    is_pass = action >= nn
    stones_p, n_cap, ko_p = B.play_move(
        stones, size, to_move, action.clamp(max=nn - 1)
    )
    new_stones = torch.where(is_pass[:, None, None], stones, stones_p)
    new_ko = torch.where(is_pass, NO_VERTEX, ko_p).to(torch.int32)
    out = board_analysis_plain(new_stones, size, new_ko, 1 - to_move)
    out.update(
        new_stones=new_stones,
        n_captured=torch.where(is_pass, 0, n_cap).to(torch.int32),
        new_ko=new_ko,
        new_hash=B.position_hash(new_stones),
    )
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from sayuri_tpu_torch.ops import build

    lib = build.load("analysis")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_board_analysis.argtypes = [vp] * 4 + [vp] * 5 + [i, i, vp]
    lib.launch_board_analysis.restype = i
    lib.launch_step_analysis.argtypes = [vp] * 6 + [vp] * 9 + [i, i, vp]
    lib.launch_step_analysis.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _zobrist_rows(n: int, device: str):
    """[4, nn] int32 key rows (black w0/w1, white w0/w1) as bit patterns."""
    import numpy as np

    cells, _ = B.zobrist_numpy(n)
    rows = np.stack([cells[0, C_BLACK], cells[1, C_BLACK],
                     cells[0, C_WHITE], cells[1, C_WHITE]])
    return torch.from_numpy(rows.view(np.int32).copy()).to(device)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(stones, scalars):
    if stones.ndim != 3 or stones.shape[1] != stones.shape[2]:
        raise ValueError(f"stones: shape {tuple(stones.shape)}, expected [B, n, n]")
    b, n = stones.shape[0], stones.shape[-1]
    if n > MAX_N:
        raise ValueError(f"board buffer n={n} exceeds {MAX_N}")
    _check("stones", stones, torch.int8, (b, n, n), stones.device)
    for name, t in scalars.items():
        _check(name, t, torch.int32, (b,), stones.device)
    return b, n


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_if(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def board_analysis(stones, size, ko, to_move):
    """Analysis of a batch of positions: [B, n, n] int8 stones, [B] int32
    size/ko/to_move -> dict(legal [B, nn] bool, libs [B, n, n] int32 capped
    at 5, ownership, safe, score_ownership [B, n, n])."""
    if stones.device.type == "cpu":
        return board_analysis_plain(stones, size, ko, to_move)
    if stones.device.type != "cuda":
        raise ValueError(f"board_analysis: unsupported device {stones.device}")
    b, n = _check_inputs(stones, {"size": size, "ko": ko, "to_move": to_move})
    dev = stones.device
    legal = torch.empty((b, n * n), dtype=torch.bool, device=dev)
    libs = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    own = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    safe = torch.empty((b, n, n), dtype=torch.bool, device=dev)
    sown = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    if b:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().launch_board_analysis(
            _ptr(stones), _ptr(size), _ptr(ko), _ptr(to_move),
            _ptr(legal), _ptr(libs), _ptr(own), _ptr(safe), _ptr(sown),
            b, n, ctypes.c_void_p(stream),
        )
        _raise_if(rc, "board_analysis")
        LAUNCHES["board_analysis"] += 1
    return {"legal": legal, "libs": libs, "ownership": own, "safe": safe,
            "score_ownership": sown}


def step_and_analyze(stones, size, ko, to_move, action):
    """Batched env step + child analysis: [B, n, n] int8 stones, [B] int32
    size/ko/to_move/action (>= n*n is a pass). Returns the analysis dict of
    the child (side to move flipped) plus new_stones [B, n, n] int8,
    n_captured [B] int32, new_ko [B] int32 and new_hash [B, 2] int64
    (two 32-bit words)."""
    if stones.device.type == "cpu":
        return step_and_analyze_plain(stones, size, ko, to_move, action)
    if stones.device.type != "cuda":
        raise ValueError(f"step_and_analyze: unsupported device {stones.device}")
    b, n = _check_inputs(stones, {"size": size, "ko": ko, "to_move": to_move,
                                  "action": action})
    dev = stones.device
    zob = _zobrist_rows(n, str(dev))
    new_stones = torch.empty((b, n, n), dtype=torch.int8, device=dev)
    ncap = torch.empty((b,), dtype=torch.int32, device=dev)
    ko2 = torch.empty((b,), dtype=torch.int32, device=dev)
    h = torch.empty((b, 2), dtype=torch.int32, device=dev)
    legal = torch.empty((b, n * n), dtype=torch.bool, device=dev)
    libs = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    own = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    safe = torch.empty((b, n, n), dtype=torch.bool, device=dev)
    sown = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    if b:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().launch_step_analysis(
            _ptr(stones), _ptr(size), _ptr(ko), _ptr(to_move), _ptr(action),
            _ptr(zob),
            _ptr(new_stones), _ptr(ncap), _ptr(ko2), _ptr(h),
            _ptr(legal), _ptr(libs), _ptr(own), _ptr(safe), _ptr(sown),
            b, n, ctypes.c_void_p(stream),
        )
        _raise_if(rc, "step_and_analyze")
        LAUNCHES["step_and_analyze"] += 1
    return {
        "new_stones": new_stones,
        "n_captured": ncap,
        "new_ko": ko2,
        "new_hash": h.to(torch.int64) & 0xFFFFFFFF,
        "legal": legal,
        "libs": libs,
        "ownership": own,
        "safe": safe,
        "score_ownership": sown,
    }
