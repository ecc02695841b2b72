"""The port's span-and-counter recorder.

Every ``MCTS.run`` call is one run record: the host ns of each span opened
while it runs, summed by span name (nested spans count in their own name
and in their parent's), and the counters the search adds (the descent's
host syncs, the lane-simulations inside their playout budget). The last
``KEEP`` records stay in memory for the benchmark's readers
(``port_bench/metrics/``) and for ``bench profile``.

A span always costs two clock reads. A span opened with ``profiled=True``
also opens a ``torch.profiler.record_function`` range while the profiler
is on, and then marks the run record as profiled; with the profiler off it
costs one flag check more, not the range's enter and exit. A range is
stamped on kineto's clock, so the device trace names the program's spans
as it named the bare ranges. ``last(profiled=False)`` is the newest record
made entirely with the profiler off: its times carry none of the
profiler's cost.

The recorder adds no host sync and no device work: a counter is a host
int, or a device scalar that its reader converts (``RunRecord.counter``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch.profiler import record_function

KEEP = 64
_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns


@dataclasses.dataclass
class RunRecord:
    """One ``MCTS.run`` call."""

    seq: int
    sims: int
    profiled: bool                 # the profiler was on at some point of the call
    ns: dict = dataclasses.field(default_factory=dict)        # host ns by span name
    counters: dict = dataclasses.field(default_factory=dict)  # int or device scalar

    def ms(self, name) -> float:
        """Host ms in the spans called `name`."""
        return self.ns.get(name, 0) / 1e6

    def counter(self, name) -> int:
        """A counter's value (0 if never counted); a device scalar is read
        here, once."""
        return int(self.counters.get(name, 0))


class _Span:
    __slots__ = ("rec", "name", "range", "t0")

    def __init__(self, rec, name, rng):
        self.rec, self.name, self.range = rec, name, rng

    def __enter__(self):
        self.t0 = _clock()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        dt = _clock() - self.t0
        if self.rec is not None:
            ns = self.rec.ns
            ns[self.name] = ns.get(self.name, 0) + dt


class Recorder:
    """Run records of the calls each thread makes, the newest `keep` of
    them kept."""

    def __init__(self, keep=KEEP):
        self.records = collections.deque(maxlen=keep)
        self._seq = itertools.count()
        self._local = threading.local()

    def current(self):
        """The calling thread's open run record, or None."""
        return getattr(self._local, "rec", None)

    @contextlib.contextmanager
    def run(self, sims):
        """Open a run record of `sims` simulations for the calling thread;
        it is kept when the block ends without an exception."""
        prev = self.current()
        rec = RunRecord(next(self._seq), sims, _profiler_enabled())
        self._local.rec = rec
        try:
            yield rec
        finally:
            self._local.rec = prev
        rec.profiled = rec.profiled or _profiler_enabled()
        self.records.append(rec)

    def span(self, name, profiled=True):
        """Context manager: the block's host ns added to the open record
        under `name` (to nothing outside a record); with `profiled`, a
        profiler range of that name while the profiler is on."""
        rec = self.current()
        rng = None
        if profiled and _profiler_enabled():
            rng = record_function(name)
            if rec is not None:
                rec.profiled = True
        return _Span(rec, name, rng)

    def count(self, name, n=1):
        """Add `n` (an int or a device scalar) to the open record's counter."""
        rec = self.current()
        if rec is not None:
            c = rec.counters
            c[name] = c[name] + n if name in c else n

    def last(self, profiled=False):
        """The newest kept record whose `profiled` is `profiled`, or None."""
        for rec in reversed(list(self.records)):
            if rec.profiled == profiled:
                return rec
        return None


RECORDER = Recorder()
run, span, count, last = RECORDER.run, RECORDER.span, RECORDER.count, RECORDER.last
