"""Training-chunk serialization in the reference's 53-line v2 text format
(PyTorch port of sayuri_tpu.selfplay.data; the text is plain numpy).

  L1 version(2) / L2 mode(0) / L3 bsize / L4 komi / L5 rule / L6 wave
  L7-L43  : 37 binary planes, hex-packed 4 cells per digit (+ last odd cell)
  L44     : side to move (1=black)
  L45/L46 : target policy / auxiliary policy (N*N+1 floats)
  L47     : ownership chars (0 neutral, 1 mine, 3 theirs)
  L48     : game result (stm +-1/0)
  L49     : avg, short, middle, long Q
  L50     : final score (stm)
  L51     : avg, short, middle, long score
  L52     : Q stddev, score stddev
  L53     : policy KLD

Discarded rows (fast-search data) are skipped. Chunks are gzip files,
90% to tdata/<run_id>/ and 10% to vdata/<run_id>/. The planes come from
the port's encoder (``encode_states``: the analysis kernel and the ladder
kernels on the card).
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

NUM_BINARY_PLANES = 37  # 43 - 6 misc planes
VAL_FRACTION = 0.1      # share of games written to vdata/


def _fmt(x) -> str:
    """C++ operator<< float formatting (6 significant digits)."""
    return f"{float(x):.6g}"


def _pack_plane(plane: np.ndarray) -> str:
    """Hex-pack one flat binary plane."""
    bits = plane.astype(np.int64)
    n4 = (len(bits) // 4) * 4
    quads = bits[:n4].reshape(-1, 4)
    hexvals = quads[:, 0] + (quads[:, 1] << 1) + (quads[:, 2] << 2) + (quads[:, 3] << 3)
    s = "".join("0123456789abcdef"[v] for v in hexvals)
    if len(bits) % 4 != 0:
        s += "1" if bits[-1] else "0"
    return s


def serialize_position(
    planes: np.ndarray,     # [43, HW] plane-major (already size-cropped)
    bsize: int,
    komi: float,
    rule: float,
    wave: float,
    stm_is_black: bool,
    probabilities: np.ndarray,       # [HW + 1]
    aux_probabilities: np.ndarray,   # [HW + 1]
    ownership: np.ndarray,           # [HW] ints in {-1, 0, 1} (stm persp)
    result: int,
    avg_q: float, short_q: float, middle_q: float, long_q: float,
    final_score: float,
    avg_s: float, short_s: float, middle_s: float, long_s: float,
    q_stddev: float, score_stddev: float,
    kld: float,
) -> str:
    lines = ["2", "0", str(bsize), _fmt(komi), _fmt(rule), _fmt(wave)]
    for p in range(NUM_BINARY_PLANES):
        lines.append(_pack_plane(planes[p]))
    lines.append("1" if stm_is_black else "0")
    lines.append(" ".join(_fmt(v) for v in probabilities))
    lines.append(" ".join(_fmt(v) for v in aux_probabilities))
    lines.append("".join("1" if v == 1 else ("3" if v == -1 else "0") for v in ownership))
    lines.append(str(int(result)))
    lines.append(" ".join(_fmt(v) for v in (avg_q, short_q, middle_q, long_q)))
    lines.append(_fmt(final_score))
    lines.append(" ".join(_fmt(v) for v in (avg_s, short_s, middle_s, long_s)))
    lines.append(f"{_fmt(q_stddev)} {_fmt(score_stddev)}")
    lines.append(_fmt(kld))
    return "\n".join(lines) + "\n"


def crop_planes(planes_nhwc: np.ndarray, size: int) -> np.ndarray:
    """[n, n, 43] buffer -> [43, size*size] plane-major on the real board."""
    sub = planes_nhwc[:size, :size, :]
    return np.moveaxis(sub, -1, 0).reshape(planes_nhwc.shape[-1], -1)


def encode_states(env, states):
    """[B, n, n, 43] float32 input planes of a GoState batch, with the full
    ladder planes and the board analysis (the kernels on the card)."""
    from sayuri_tpu_torch.game.ladder import ladder_planes_batch
    from sayuri_tpu_torch.models.encoder import encode
    from sayuri_tpu_torch.ops.analysis import board_analysis

    an = board_analysis(states.stones, states.size, states.ko, states.to_move)
    lp = ladder_planes_batch(states.stones, states.size, states.ko)
    return encode(env, states, lp, an["libs"], an["safe"], an["score_ownership"])


def games_to_text(env, records, targets):
    """Serialize a finished batch to per-game position strings.

    Returns list[list[str]]: for each game, its non-discarded positions."""
    b = records[0].q_value.shape[0]
    end = targets["end"].cpu().numpy()
    tg = {k: v.cpu().numpy() for k, v in targets.items()}

    games = [[] for _ in range(b)]
    for t, rec in enumerate(records):
        live = rec.active.cpu().numpy() & (t < end)
        keep = live & ~rec.discard.cpu().numpy()
        if not keep.any():
            continue
        planes = encode_states(env, rec.states).cpu().numpy()   # [B, n, n, 43]
        sizes = rec.states.size.cpu().numpy()
        komis = rec.states.komi.cpu().numpy()
        rules = rec.states.rule.cpu().numpy()
        to_move = rec.states.to_move.cpu().numpy()
        tp = rec.target_policy.cpu().numpy()
        q_sd = rec.q_stddev.cpu().numpy()
        s_sd = rec.score_stddev.cpu().numpy()
        kld = rec.kld.cpu().numpy()
        aux, own = tg["aux_policy"][t], tg["ownership"][t]
        for i in range(b):
            if not keep[i]:
                continue
            size = int(sizes[i])
            sel = _board_index(env.n, size)
            games[i].append(serialize_position(
                planes=crop_planes(planes[i], size),
                bsize=size,
                komi=float(komis[i]),
                rule=float(rules[i]),
                wave=float(planes[i, 0, 0, 38]),
                stm_is_black=int(to_move[i]) == 0,
                probabilities=_crop_policy(tp[i], env.n, size),
                aux_probabilities=_crop_policy(aux[i], env.n, size),
                ownership=np.rint(own[i][sel]).astype(np.int64),
                result=int(tg["result"][t, i]),
                avg_q=tg["avg_q"][t, i],
                short_q=tg["short_q"][t, i],
                middle_q=tg["middle_q"][t, i],
                long_q=tg["long_q"][t, i],
                final_score=tg["final_score"][t, i],
                avg_s=tg["avg_score"][t, i],
                short_s=tg["short_score"][t, i],
                middle_s=tg["middle_score"][t, i],
                long_s=tg["long_score"][t, i],
                q_stddev=float(q_sd[i]),
                score_stddev=float(s_sd[i]),
                kld=float(kld[i]),
            ))
    return games


def _board_index(n: int, size: int) -> np.ndarray:
    """Flat indices of the real size x size board inside the n x n buffer."""
    r = np.arange(size)
    return (r[:, None] * n + r[None, :]).reshape(-1)


def _crop_policy(p: np.ndarray, n: int, size: int) -> np.ndarray:
    """[n*n+1] buffer policy -> [size*size+1] board policy (renormalized)."""
    sel = _board_index(n, size)
    out = np.concatenate([p[sel], p[-1:]])
    s = out.sum()
    return out / s if s > 0 else out


def write_chunks(games: list[list[str]], out_dir: str, run_id: str, seed: int = 0):
    """Write games as gzip chunks: 90% to tdata/<run_id>/, 10% to
    vdata/<run_id>/. Returns the number of files written."""
    rng = np.random.RandomState(seed)
    tdir = Path(out_dir) / "tdata" / run_id
    vdir = Path(out_dir) / "vdata" / run_id
    tdir.mkdir(parents=True, exist_ok=True)
    vdir.mkdir(parents=True, exist_ok=True)
    n_written = 0
    for gi, positions in enumerate(games):
        if not positions:
            continue
        dest = vdir if rng.rand() < VAL_FRACTION else tdir
        with gzip.open(dest / f"{run_id}_{gi:06d}.txt.gz", "wt") as f:
            f.write("".join(positions))
        n_written += 1
    return n_written

