"""Board step + analysis kernels (CUDA, csrc/analysis.cu) and their plain
PyTorch twins.

Four entry points, each a hand-written CUDA kernel for sm_90a:

- ``step_and_analyze`` replaces the Pallas ``_step_analysis_kernel``
  (sayuri_tpu/ops/analysis.py, entry ``step_and_analyze_tpu``): play the
  move, hash the child, and analyse the child with the side to move
  flipped. It runs once per search simulation.
- ``board_analysis`` replaces the Pallas ``_analysis_kernel`` (entry
  ``board_analysis_tpu``): the same analysis on a position without a move.
  It serves the root evaluation.
- ``ladder_prep`` replaces the Pallas ``_ladder_prep_kernel`` (entry
  ``ladder_prep_tpu``): the per-cell maps the ladder front end
  (game/ladder.py) extracts its candidate chains from. It runs once per
  ladder-plane batch.
- ``step_and_legal`` replaces the Pallas ``_step_legal_kernel`` (entry
  ``step_and_legal_tpu``): play the move, hash the child, and only the
  child's legality. It is the raw env-stepping path
  (``GoEnv.step_batch_light``: the env-steps bench).

The analysis outputs are: legality, per-stone chain liberties capped at 5,
Tromp-Taylor reach ownership, the safe (pass-alive / pass-dead) area of
both colours and the score-area ownership.

A wrapper given CPU tensors computes the plain twin (built from
game/board.py and game/analysis.py, with the plain fixpoints, so a twin on
CUDA tensors launches no kernel); given CUDA tensors it launches the kernel
or raises. ``LAUNCHES`` counts kernel launches per entry point.
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
LAUNCHES = {"step_and_analyze": 0, "board_analysis": 0, "ladder_prep": 0,
            "step_and_legal": 0}


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
        libs = libs + B.chain_liberty_map(m, B.chain_labels_plain(m), empty)
    safe, sown = GA.safe_and_ownership(stones, size)
    return {
        "legal": B.legal_moves(stones, size, to_move, ko, plain=True),
        "libs": libs.clamp(max=_NUM_LIBS).to(torch.int32),
        "ownership": B.area_ownership(stones, size, plain=True).to(torch.int32),
        "safe": safe,
        "score_ownership": sown.to(torch.int32),
    }


def _step_plain(stones, size, to_move, action):
    """The play-and-hash half of both step kernels: play `action` (>= n*n
    is a pass) -> dict(new_stones [B, n, n] int8, n_captured [B] int32,
    new_ko [B] int32, new_hash [B, 2] int64)."""
    nn = stones.shape[-1] ** 2
    is_pass = action >= nn
    stones_p, n_cap, ko_p = B.play_move(
        stones, size, to_move, action.clamp(max=nn - 1), plain=True
    )
    new_stones = torch.where(is_pass[:, None, None], stones, stones_p)
    return {
        "new_stones": new_stones,
        "n_captured": torch.where(is_pass, 0, n_cap).to(torch.int32),
        "new_ko": torch.where(is_pass, NO_VERTEX, ko_p).to(torch.int32),
        "new_hash": B.position_hash(new_stones),
    }


def step_and_analyze_plain(stones, size, ko, to_move, action):
    """Plain PyTorch version of the step+analysis kernel: play `action`
    (>= n*n is a pass), hash the child, analyse it with the side to move
    flipped. Returns the analysis dict plus new_stones [B, n, n] int8,
    n_captured [B] int32, new_ko [B] int32, new_hash [B, 2] int64."""
    out = _step_plain(stones, size, to_move, action)
    out.update(board_analysis_plain(out["new_stones"], size, out["new_ko"],
                                    1 - to_move))
    return out


def step_and_legal_plain(stones, size, ko, to_move, action):
    """Plain PyTorch version of the light step kernel: play `action` (>=
    n*n is a pass), hash the child, and the child's legality for the side
    to move after it. Returns new_stones [B, n, n] int8, n_captured [B]
    int32, new_ko [B] int32, new_hash [B, 2] int64, legal [B, n*n] bool."""
    out = _step_plain(stones, size, to_move, action)
    out["legal"] = B.legal_moves(out["new_stones"], size, 1 - to_move,
                                 out["new_ko"], plain=True)
    return out


def _chain_lib_vertices(labels, empty):
    """Per-chain-root first and second liberty vertex ([B, nn] int64 each,
    nn where absent): scatter-min of the adjacent empty cells into roots."""
    n = labels.shape[-1]
    nn = n * n
    b = labels.shape[0]
    nbr = torch.where(empty[:, None], B.neighbor_labels(labels), -1)
    tgt = torch.where(nbr >= 0, nbr, nn).reshape(b, 4 * nn)
    cell = B.flat_iota(n, labels.device).reshape(1, 1, nn).expand(b, 4, nn)
    cell = cell.reshape(b, 4 * nn)
    init = torch.full((b, nn + 1), nn, dtype=torch.int64, device=labels.device)
    lib1 = init.scatter_reduce(1, tgt, cell, "amin")
    tgt2 = torch.where(cell == lib1.gather(1, tgt), nn, tgt)
    lib2 = init.scatter_reduce(1, tgt2, cell, "amin")
    return lib1[:, :nn], lib2[:, :nn]


def ladder_prep_plain(stones, size, ko):
    """Plain PyTorch version of the ladder prep kernel. [B, n, n] int8
    stones, [B] int32 size/ko -> dict of [B, nn] maps: labels int32 (chain
    root = smallest flat index, -1 off a chain), nlibs int32 (the chain's
    liberties capped at 3, 0 off a chain), lib1/lib2 int32 (the chain's
    first/second liberty vertex, nn when absent or off a chain),
    legal_black/legal_white bool (IsLegalMove of one vertex: empty, not
    the ko vertex, and an empty neighbour, an own neighbour chain with >= 2
    liberties or an opponent neighbour chain in atari)."""
    n = stones.shape[-1]
    nn = n * n
    b = stones.shape[0]
    mask = B.board_mask(size, n, stones.device)
    empty = (stones == 0) & mask
    black = (stones == C_BLACK) & mask
    white = (stones == C_WHITE) & mask
    lbl_b, lbl_w = B.chain_labels_plain(black), B.chain_labels_plain(white)
    labels = torch.where(lbl_b >= 0, lbl_b, lbl_w)
    libs = (B.chain_liberty_map(black, lbl_b, empty)
            + B.chain_liberty_map(white, lbl_w, empty))
    lib1, lib2 = _chain_lib_vertices(labels, empty)
    flat_lbl = labels.reshape(b, nn)
    stone = flat_lbl >= 0
    root = flat_lbl.clamp(min=0)
    not_ko = B.flat_iota(n, stones.device) != ko.to(torch.int64)[:, None, None]
    base = empty & not_ko
    emp_nb = B.nbr_or(empty)

    def legal(own, opp):
        ok = emp_nb | B.nbr_or(own & (libs >= 2)) | B.nbr_or(opp & (libs == 1))
        return (base & ok).reshape(b, nn)

    i32 = torch.int32
    return {
        "labels": flat_lbl.to(i32),
        "nlibs": libs.clamp(max=3).reshape(b, nn).to(i32),
        "lib1": torch.where(stone, lib1.gather(1, root), nn).to(i32),
        "lib2": torch.where(stone, lib2.gather(1, root), nn).to(i32),
        "legal_black": legal(black, white),
        "legal_white": legal(white, black),
    }


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from sayuri_tpu_torch.ops import build

    return bind(build.load("analysis"))


def bind(lib):
    """Set the argument and result types of analysis.cu's launchers on a
    loaded library; returns it."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_board_analysis.argtypes = [vp] * 4 + [vp] * 5 + [i, i, vp]
    lib.launch_board_analysis.restype = i
    lib.launch_step_analysis.argtypes = [vp] * 6 + [vp] * 9 + [i, i, vp]
    lib.launch_step_analysis.restype = i
    lib.launch_ladder_prep.argtypes = [vp] * 3 + [vp] * 6 + [i, i, vp]
    lib.launch_ladder_prep.restype = i
    lib.launch_step_legal.argtypes = [vp] * 6 + [vp] * 5 + [i, i, vp]
    lib.launch_step_legal.restype = i
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


def step_and_legal(stones, size, ko, to_move, action):
    """Batched light env step: [B, n, n] int8 stones, [B] int32
    size/ko/to_move/action (>= n*n is a pass). Returns new_stones [B, n, n]
    int8, n_captured [B] int32, new_ko [B] int32, new_hash [B, 2] int64 (two
    32-bit words) and legal [B, n*n] bool, the child's legality for the
    side to move after the move."""
    if stones.device.type == "cpu":
        return step_and_legal_plain(stones, size, ko, to_move, action)
    if stones.device.type != "cuda":
        raise ValueError(f"step_and_legal: unsupported device {stones.device}")
    b, n = _check_inputs(stones, {"size": size, "ko": ko, "to_move": to_move,
                                  "action": action})
    dev = stones.device
    zob = _zobrist_rows(n, str(dev))
    new_stones = torch.empty((b, n, n), dtype=torch.int8, device=dev)
    ncap = torch.empty((b,), dtype=torch.int32, device=dev)
    ko2 = torch.empty((b,), dtype=torch.int32, device=dev)
    h = torch.empty((b, 2), dtype=torch.int32, device=dev)
    legal = torch.empty((b, n * n), dtype=torch.bool, device=dev)
    if b:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().launch_step_legal(
            _ptr(stones), _ptr(size), _ptr(ko), _ptr(to_move), _ptr(action),
            _ptr(zob), _ptr(new_stones), _ptr(ncap), _ptr(ko2), _ptr(h),
            _ptr(legal), b, n, ctypes.c_void_p(stream),
        )
        _raise_if(rc, "step_and_legal")
        LAUNCHES["step_and_legal"] += 1
    return {
        "new_stones": new_stones,
        "n_captured": ncap,
        "new_ko": ko2,
        "new_hash": h.to(torch.int64) & 0xFFFFFFFF,
        "legal": legal,
    }


def ladder_prep(stones, size, ko):
    """Ladder candidate maps of a batch: [B, n, n] int8 stones, [B] int32
    size/ko -> dict(labels, nlibs, lib1, lib2 [B, nn] int32, legal_black,
    legal_white [B, nn] bool); see ladder_prep_plain."""
    if stones.device.type == "cpu":
        return ladder_prep_plain(stones, size, ko)
    if stones.device.type != "cuda":
        raise ValueError(f"ladder_prep: unsupported device {stones.device}")
    b, n = _check_inputs(stones, {"size": size, "ko": ko})
    dev = stones.device
    out = {k: torch.empty((b, n * n), dtype=torch.int32, device=dev)
           for k in ("labels", "nlibs", "lib1", "lib2")}
    out.update({k: torch.empty((b, n * n), dtype=torch.bool, device=dev)
                for k in ("legal_black", "legal_white")})
    if b:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().launch_ladder_prep(
            _ptr(stones), _ptr(size), _ptr(ko), *(_ptr(t) for t in out.values()),
            b, n, ctypes.c_void_p(stream),
        )
        _raise_if(rc, "ladder_prep")
        LAUNCHES["ladder_prep"] += 1
    return out
