"""Training data pipeline: 53-line chunk parser, KLD surprise sampling,
shuffle-buffer streaming, growing window (the port's own copy of
sayuri_tpu.train.dataset, plain Python and numpy; the chunks are those
that sayuri_tpu_torch.selfplay.data writes).

- lazy parse: only version + KLD are read before the sampling decision;
- policy-surprise down-sampling: sample prob ~ (1 - f) + f * kld/kld_mean
  times 1/down_sample_rate, with a warmup on the running mean;
- random 8-fold symmetry per sample;
- shuffle buffer with insert-and-pop-random;
- KataGo growing window over the newest chunks;
- one worker thread and one seeded ``random.Random`` per loader, so a seed
  gives the same batches;
- each kept sample is parsed by the native codec (``sayuri_tpu_torch.native``)
  when it builds, by ``Sample.parse`` when it does not. A departure from the
  JAX loader, which parses in Python only: the batches are byte-identical
  either way, and only the samples the sampler keeps are parsed.
"""

from __future__ import annotations

import gzip
import math
import os
import random
import threading
import queue as queue_mod
from pathlib import Path

import numpy as np

from sayuri_tpu_torch import native

V2_DATA_LINES = 53
NUM_BINARY_PLANES = 37
INPUT_CHANNELS = 43


class Sample:
    """One parsed position (the reference's Data, data.py)."""

    __slots__ = (
        "board_size", "komi", "rule", "wave", "to_move", "planes", "prob",
        "aux_prob", "ownership", "result", "avg_q", "short_avg_q",
        "mid_avg_q", "long_avg_q", "final_score", "avg_score",
        "short_avg_score", "mid_avg_score", "long_avg_score", "q_stddev",
        "score_stddev", "kld", "lines",
    )

    def __init__(self, lines):
        self.lines = lines
        self.kld = float(lines[52])

    def _parse_scalars(self):
        ln = self.lines
        if int(ln[0]) != 2:
            raise ValueError(f"unsupported data version {ln[0]}")
        self.board_size = int(ln[2])
        self.komi = float(ln[3])
        self.rule = float(ln[4])
        self.wave = float(ln[5])
        self.to_move = int(ln[43])  # 1 = black
        self.result = int(ln[47])
        q4 = [float(x) for x in ln[48].split()]
        self.avg_q, self.short_avg_q, self.mid_avg_q, self.long_avg_q = q4
        self.final_score = float(ln[49])
        s4 = [float(x) for x in ln[50].split()]
        (
            self.avg_score,
            self.short_avg_score,
            self.mid_avg_score,
            self.long_avg_score,
        ) = s4
        qs = [float(x) for x in ln[51].split()]
        self.q_stddev, self.score_stddev = qs
        return self.board_size * self.board_size

    def parse(self):
        ln = self.lines
        hw = self._parse_scalars()
        planes = np.zeros((NUM_BINARY_PLANES, hw), np.float32)
        for p in range(NUM_BINARY_PLANES):
            planes[p] = _unpack_plane(ln[6 + p], hw)
        self.planes = planes
        self.prob = np.asarray([float(x) for x in ln[44].split()], np.float32)
        self.aux_prob = np.asarray(
            [float(x) for x in ln[45].split()], np.float32
        )
        own = np.zeros(hw, np.float32)
        for i, ch in enumerate(ln[46].strip()):
            own[i] = 1.0 if ch == "1" else (-1.0 if ch == "3" else 0.0)
        self.ownership = own
        return self

    def parse_native(self):
        """``parse`` with the planes, policies and ownership from the native
        codec, at this sample's own board size: the same arrays (the codec
        reads each number with strtod and casts it to float32, as ``float``
        and numpy do). The few scalars are read in Python, as ``parse``
        reads them. A line that ``parse`` (or ``wrap_sample`` after it)
        rejects, the codec rejects too, with ValueError; it also rejects a
        plane or ownership line of the wrong length and a policy line with
        numbers left over, which the Python path pads or cuts."""
        self._parse_scalars()
        out = native.parse_positions("\n".join(self.lines), self.board_size, cap=1)
        if out is None:
            raise RuntimeError("the native chunk codec is not available")
        if out["planes"].shape[0] != 1:
            raise ValueError("codec parsed no position")
        self.planes = out["planes"][0]
        self.prob = out["prob"][0]
        self.aux_prob = out["aux"][0]
        self.ownership = out["own"][0]
        return self

    def apply_symmetry(self, symm):
        n = self.board_size
        self.planes = _sym_planes(
            self.planes.reshape(-1, n, n), symm
        ).reshape(-1, n * n)
        self.ownership = _sym_planes(
            self.ownership.reshape(1, n, n), symm
        ).reshape(-1)
        self.prob = _sym_prob(self.prob, n, symm)
        self.aux_prob = _sym_prob(self.aux_prob, n, symm)


def _unpack_plane(line, hw):
    out = np.zeros(hw, np.float32)
    n4 = (hw // 4) * 4
    for i, ch in enumerate(line[: n4 // 4]):
        v = int(ch, 16)
        base = i * 4
        out[base] = v & 1
        out[base + 1] = (v >> 1) & 1
        out[base + 2] = (v >> 2) & 1
        out[base + 3] = (v >> 3) & 1
    if hw % 4:
        out[-1] = float(line[n4 // 4] == "1")
    return out


def _sym_planes(x, symm):
    if symm & 4:
        x = np.swapaxes(x, -2, -1)
    if symm & 2:
        x = np.flip(x, axis=-2)
    if symm & 1:
        x = np.flip(x, axis=-1)
    return np.ascontiguousarray(x)


def _sym_prob(p, n, symm):
    spatial = _sym_planes(p[: n * n].reshape(1, n, n), symm).reshape(-1)
    return np.concatenate([spatial, p[n * n :]])


def read_chunk(path):
    """Yield Sample objects (unparsed) from a chunk file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()
    for i in range(0, len(lines) - V2_DATA_LINES + 1, V2_DATA_LINES):
        yield Sample(lines[i : i + V2_DATA_LINES])


class SurpriseSampler:
    """Policy-surprise weighted down-sampling (train.py:63-93)."""

    def __init__(self, down_sample_rate, policy_surprise_factor=0.0,
                 virtual_buffsize=8000 * 50, rng=None):
        self.down_sample_rate = down_sample_rate
        self.factor = policy_surprise_factor
        self.virtual_buffsize = virtual_buffsize
        self.running_kld_mean = 1.0
        self.count = 0
        self.rng = rng or random.Random(0)

    def __call__(self, kld):
        gamma_factor = math.exp(
            max(self.virtual_buffsize - self.count, 0)
            / (self.virtual_buffsize / 2.71828182846)
        )
        gamma = (1.0 / self.virtual_buffsize) * gamma_factor
        self.running_kld_mean = (
            1.0 - gamma
        ) * self.running_kld_mean + gamma * kld
        self.count += 1
        freq = (1.0 - self.factor) + self.factor * (
            kld / max(self.running_kld_mean, 1e-8)
        )
        if self.down_sample_rate <= 1:
            return True
        return freq * (1.0 / self.down_sample_rate) > self.rng.random()


def compute_window_size(N, c=5000, scale=1.0, alpha=0.75, beta=0.4):
    """KataGo growing-window formula (train.py:439-445,
    https://arxiv.org/abs/1902.10565v5)."""
    if N <= 0:
        return 0
    return round(scale * c * (1 + beta * (math.pow(N / c, alpha) - 1) / alpha))


def select_window_chunks(train_dir, c=5000, scale=1.0, alpha=0.75, beta=0.4,
                         max_chunks=None):
    """Newest-window chunk selection (train.py:446-463)."""
    files = sorted(
        Path(train_dir).rglob("*.txt.gz"), key=os.path.getmtime
    ) + sorted(Path(train_dir).rglob("*.txt"), key=os.path.getmtime)
    n_all = len(files)
    w = compute_window_size(n_all, c, scale, alpha, beta)
    if max_chunks is not None:
        w = min(w, max_chunks)
    w = min(w, n_all)
    return files[n_all - w :], n_all


def wrap_sample(sample: Sample, nn_size: int):
    """Zero-pad a parsed sample into fixed nn_size buffers and build the
    target dict entries (BatchGenerator._wrap_data, train.py:117-186).
    Returns (planes [n, n, 43] NHWC, targets dict of numpy)."""
    n = nn_size
    bs = sample.board_size
    hw_n = n * n

    planes = np.zeros((INPUT_CHANNELS, n, n), np.float32)
    planes[:NUM_BINARY_PLANES, :bs, :bs] = sample.planes.reshape(-1, bs, bs)
    planes[37, :bs, :bs] = sample.rule
    planes[38, :bs, :bs] = sample.wave
    komi = sample.komi if sample.to_move == 1 else -sample.komi
    planes[39, :bs, :bs] = komi / 20.0
    planes[40, :bs, :bs] = -komi / 20.0
    planes[41, :bs, :bs] = (bs * bs) / 361.0
    planes[42, :bs, :bs] = 1.0

    prob = np.zeros(hw_n + 1, np.float32)
    prob[:hw_n].reshape(n, n)[:bs, :bs] = sample.prob[: bs * bs].reshape(
        bs, bs
    )
    prob[hw_n] = sample.prob[bs * bs]
    aux = np.zeros(hw_n + 1, np.float32)
    aux[:hw_n].reshape(n, n)[:bs, :bs] = sample.aux_prob[: bs * bs].reshape(
        bs, bs
    )
    aux[hw_n] = sample.aux_prob[bs * bs]

    ownership = np.zeros((n, n), np.float32)
    ownership[:bs, :bs] = sample.ownership.reshape(bs, bs)

    wdl = np.zeros(3, np.float32)
    wdl[1 - sample.result] = 1.0
    q_vals = np.asarray(
        [sample.result, sample.avg_q, sample.short_avg_q, sample.mid_avg_q,
         sample.long_avg_q],
        np.float32,
    )
    scores = np.asarray(
        [sample.final_score, sample.avg_score, sample.short_avg_score,
         sample.mid_avg_score, sample.long_avg_score],
        np.float32,
    )
    return np.moveaxis(planes, 0, -1), {
        "prob": prob,
        "aux_prob": aux,
        "ownership": ownership.reshape(-1),
        "wdl": wdl,
        "q_vals": q_vals,
        "scores": scores,
        "global_weight": np.float32(1.0),
    }


class ShuffleBuffer:
    """Insert-and-pop-random shuffle buffer (lazy_loader.py:6-25)."""

    def __init__(self, capacity, rng=None):
        self.capacity = max(1, capacity)
        self.buf = []
        self.rng = rng or random.Random(0)

    def insert_and_pop(self, item):
        if len(self.buf) < self.capacity:
            self.buf.append(item)
            return None
        i = self.rng.randrange(len(self.buf))
        out = self.buf[i]
        self.buf[i] = item
        return out


class ChunkLoader:
    """Threaded streaming loader: chunks -> sampler -> shuffle buffer ->
    batches (LazyLoader, lazy_loader.py:116-243)."""

    def __init__(
        self,
        files,
        nn_size,
        batch_size,
        down_sample_rate=16,
        policy_surprise_factor=0.5,
        shuffle_capacity=8192,
        seed=0,
        loop=True,
        virtual_buffsize=None,
        codec=None,
    ):
        """`codec`: None parses natively when the codec builds, True
        requires it (RuntimeError without it), False parses in Python.
        ``native_parses`` / ``python_parses`` count the parsed samples."""
        if codec is None:
            codec = native.get_lib() is not None
        elif codec and native.get_lib() is None:
            raise RuntimeError("codec=True: the native chunk codec did not build")
        self.codec = codec
        self.native_parses = 0
        self.python_parses = 0
        self.files = list(files)
        self.nn_size = nn_size
        self.batch_size = batch_size
        self.loop = loop
        self.rng = random.Random(seed)
        self.sampler = SurpriseSampler(
            down_sample_rate,
            policy_surprise_factor,
            virtual_buffsize=(
                virtual_buffsize
                if virtual_buffsize is not None
                else min(8000 * 50, max(1, len(self.files)) * 200)
            ),
            rng=self.rng,
        )
        self.shuffle = ShuffleBuffer(shuffle_capacity, self.rng)
        self.queue = queue_mod.Queue(maxsize=4)
        self.stop_flag = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _iter_samples(self):
        while True:
            files = list(self.files)
            self.rng.shuffle(files)
            for path in files:
                if self.stop_flag.is_set():
                    return
                try:
                    for s in read_chunk(path):
                        if self.sampler(s.kld):
                            yield s
                except (OSError, EOFError, ValueError):
                    continue
            if not self.loop:
                return

    def _worker(self):
        try:
            self._fill()
        except BaseException as e:  # handed to the consumer, raised there
            self.queue.put(e)
            return
        self.queue.put(None)

    def _fill(self):
        batch = []
        for s in self._iter_samples():
            if self.stop_flag.is_set():
                return
            out = self.shuffle.insert_and_pop(s)
            if out is None:
                continue
            self._parse(out)
            out.apply_symmetry(self.rng.randrange(8))
            batch.append(wrap_sample(out, self.nn_size))
            if len(batch) >= self.batch_size:
                self.queue.put(_collate(batch))
                batch = []
        # drain the shuffle buffer when not looping
        for s in self.shuffle.buf:
            self._parse(s)
            s.apply_symmetry(self.rng.randrange(8))
            batch.append(wrap_sample(s, self.nn_size))
            if len(batch) >= self.batch_size:
                self.queue.put(_collate(batch))
                batch = []

    def _parse(self, s):
        if self.codec:
            s.parse_native()
            self.native_parses += 1
        else:
            s.parse()
            self.python_parses += 1

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        """Stop the worker and wait for it to end."""
        self.stop_flag.set()
        while self.thread.is_alive():
            try:
                while True:
                    self.queue.get_nowait()
            except queue_mod.Empty:
                pass
            self.thread.join(timeout=0.05)


def _collate(batch):
    planes = np.stack([b[0] for b in batch])
    targets = {
        k: np.stack([b[1][k] for b in batch]) for k in batch[0][1]
    }
    return planes, targets
