"""The port's span-and-counter recorder (sayuri_tpu_torch/telemetry.py):
spans nest and add to the open run record only, the kept records are
bounded and the profiled ones are told apart, a span opens a profiler
range only under the profiler, and on small searches the counters match
what the search did (the descent's host syncs, the lane-simulations inside
their budget) while the recorder adds no host sync and no device work a
simulation, and no profiler range inside `mcts.evaluate`."""

import contextlib
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from sayuri_tpu_torch import telemetry as T
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts import core
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PASS9 = 81
SIMS = 6


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_spans_nest_and_add_to_the_open_record_only():
    rec = T.Recorder()
    with rec.span("outside"):
        _busy(0.001)
    assert rec.current() is None and not rec.records
    with rec.run(4) as r:
        with rec.span("outer"):
            _busy(0.002)
            with rec.span("inner"):
                _busy(0.002)
            with rec.span("inner"):
                _busy(0.002)
        rec.count("n")
        rec.count("n", 2)
    assert r.sims == 4 and not r.profiled and set(r.ns) == {"outer", "inner"}
    assert r.ns["inner"] >= 4_000_000 and r.ns["outer"] >= r.ns["inner"] + 2_000_000
    assert r.counter("n") == 3 and r.counter("absent") == 0 and r.ms("inner") == r.ns["inner"] / 1e6
    assert rec.current() is None and list(rec.records) == [r]
    rec.count("n")
    assert r.counter("n") == 3
    # a record whose block raised is not kept
    with pytest.raises(ValueError), rec.run(1):
        raise ValueError
    assert list(rec.records) == [r] and rec.current() is None


def test_records_are_bounded_and_last_skips_profiled_ones():
    rec = T.Recorder(keep=3)
    for sims in range(5):
        with rec.run(sims):
            pass
    assert [r.sims for r in rec.records] == [2, 3, 4]
    assert [r.seq for r in rec.records] == [2, 3, 4]
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.run(9):
            pass
    assert rec.last(profiled=True).sims == 9
    assert rec.last(profiled=False).sims == 4 and rec.last().sims == 4
    # the profiler turned on inside the call marks it too
    with rec.run(10):
        with profile(activities=[ProfilerActivity.CPU]):
            with rec.span("s"):
                pass
    assert rec.last(profiled=True).sims == 10 and rec.last().sims == 4
    assert T.Recorder().last() is None


def test_span_opens_a_profiler_range_only_under_the_profiler(monkeypatch):
    opened = []
    real = T.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(T, "record_function", counting)
    rec = T.Recorder()
    with rec.run(1):
        with rec.span("off"):
            pass
    assert opened == []
    names = [f"telemetry.test{i}" for i in range(6)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.run(1) as r:
            for name in names:
                with rec.span(name):
                    _busy(0.003)
            with rec.span("telemetry.unprofiled", profiled=False):
                pass
    assert opened == names and r.profiled
    events = {e.name: e for e in prof.events() if e.name.startswith("telemetry.")}
    assert sorted(events) == names
    # the profiler's first range pays its set-up; past it, the profiler's
    # duration and the recorder's agree
    gaps = sorted(abs(events[k].time_range.elapsed_us() - r.ns[k] / 1e3) for k in names[1:])
    assert gaps[len(gaps) // 2] < 100


def _roots9():
    """4 9x9 roots, lane 0 ended by two passes."""
    env = GoEnv(n=9)
    s = env.new_batch(4, komi=7.5, device="cpu")
    s = env.step(s, torch.tensor([PASS9, 10, 20, 30], dtype=torch.int32))
    s = env.step(s, torch.tensor([PASS9, 11, 21, 31], dtype=torch.int32))
    assert s.terminated.tolist() == [True, False, False, False]
    return env, s


def test_descent_syncs_and_active_lane_sims_match_the_search(monkeypatch):
    env, roots = _roots9()
    m = MCTS(env, make_dummy_eval_fn(env), SearchConfig(max_nodes=SIMS + 8, max_depth=16))
    budget = torch.tensor([SIMS, 0, 3, SIMS + 4])
    # every bool() on a tensor inside the descent: the level loop's check
    calls = [0]
    in_descent = [False]
    real_bool, real_descend = torch.Tensor.__bool__, MCTS._descend

    def counted_bool(self):
        calls[0] += in_descent[0]
        return real_bool(self)

    def descend(self, *args, **kw):
        in_descent[0] = True
        try:
            return real_descend(self, *args, **kw)
        finally:
            in_descent[0] = False

    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    monkeypatch.setattr(MCTS, "_descend", descend)
    before = len(T.RECORDER.records)
    tree = m.run(m.init_tree(roots), SIMS, budget=budget)
    monkeypatch.undo()
    rec = T.last()
    assert rec.seq >= before and rec.sims == SIMS and not rec.profiled
    assert rec.counter("descent_syncs") == calls[0] >= SIMS
    assert rec.ms("mcts.descent.sync") > 0
    assert rec.ms("mcts.descent") >= rec.ms("mcts.descent.sync")
    live = ~roots.terminated
    assert rec.counter("lane_sims") == 4 * SIMS
    assert rec.counter("lane_sims_active") == int((budget.clamp(max=SIMS) * live).sum()) == 9
    # the lanes frozen by their budget did no work: the root visits say so
    assert tree.visits[1:, 0].tolist() == [1, 4, SIMS + 1]
    # without a budget every live lane works every simulation
    m.run(m.init_tree(roots), 2)
    assert T.last().counter("lane_sims_active") == 3 * 2


class _Ops(TorchDispatchMode):
    """Counts the ATen ops run and the host syncs among them."""

    def __init__(self):
        super().__init__()
        self.ops = self.syncs = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops += 1
        self.syncs += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


def test_the_recorder_adds_no_sync_and_no_op_a_simulation(monkeypatch):
    """The search with the recorder against the loop of simulations with
    a recorder that does nothing (the search as it was before the
    recorder): the same host syncs, and only the per-call count of the
    active lane-simulations as device ops, whatever the simulations."""
    env = GoEnv(n=5)
    roots = env.new_batch(3, komi=0.5, device="cpu")
    m = MCTS(env, make_dummy_eval_fn(env), SearchConfig(max_nodes=16, max_depth=8))
    budget = torch.tensor([1, 2, 3])
    idle = types.SimpleNamespace(span=lambda *a, **k: contextlib.nullcontext(),
                                 count=lambda *a: None)

    def plain(tree, sims):
        monkeypatch.setattr(core, "T", idle)
        for i in range(sims):
            tree = m.simulate(tree, i, i < budget)
        monkeypatch.setattr(core, "T", T)

    extra = []
    for sims in (1, 3):
        counts = []
        for search in (plain, lambda tree, sims: m.run(tree, sims, budget=budget)):
            tree = m.init_tree(roots)
            with _Ops() as ops:
                search(tree, sims)
            counts.append((ops.ops, ops.syncs))
        assert counts[0][1] == counts[1][1] >= sims
        extra.append(counts[1][0] - counts[0][0])
    # a select, the wrapped 0, clamp, where and sum of the budgets, once a call
    assert extra[0] == extra[1] and 0 < extra[0] <= 5


def test_evaluate_sub_stages_are_recorded_but_not_profiled():
    """The evaluator's and the NN cache's spans go to the record only: under
    the profiler the `mcts.*` stages and the descent's syncs are ranges,
    nothing inside `mcts.evaluate` is."""
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    env, roots = _roots9()
    net = SayuriNet(NetConfig(boardsize=9, residual_channels=8,
                              stack=("ResidualBlock",))).init_random(1).eval()
    m = MCTS(env, make_eval_fn(env, net, symmetry="random", ladder_mode="off"),
             SearchConfig(max_nodes=SIMS + 8, max_depth=16, nn_cache_size=8))
    tree = m.init_tree(roots)
    m.run(tree, 2)
    rec = T.last()
    subs = ("evaluate.cache", "evaluate.encode", "evaluate.forward", "evaluate.post")
    assert set(rec.ns) == {"mcts.descent", "mcts.descent.sync", "mcts.step_analysis",
                           "mcts.evaluate", "mcts.expand_backup", *subs}
    assert sum(rec.ns[k] for k in subs) <= rec.ns["mcts.evaluate"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.run(tree, 2)
    assert T.last(profiled=True).seq > rec.seq and T.last() is rec
    names = {e.name for e in prof.events()}
    assert {"mcts.descent", "mcts.descent.sync", "mcts.step_analysis", "mcts.evaluate",
            "mcts.expand_backup"} <= names
    assert not names & set(subs)
