"""The per-layer metrics read from the program's recorder: both cells run
traced at the harness's test size on the CPU, each of their recorder
metrics comes out finite and in its range, and the self-play cell's active
lane share is the one the window's search budgets give. Against a program
without the recorder, the readers return nothing and raise nothing."""

import builtins
import math

import pytest

from port_bench import run as RUN

READ = {"search-b15c192-midgame": ("descent_syncs_per_sim.search",
                                   "sync_wait_ms_per_sim.search",
                                   "evaluate_host_ms_per_sim.search"),
        "selfplay-b6c96-19x19": ("descent_syncs_per_sim.selfplay",
                                 "sync_wait_ms_per_sim.selfplay",
                                 "active_lane_share.selfplay")}


def _searches(monkeypatch):
    """Each MCTS.run call's (simulations, budget, root terminal flags)."""
    from sayuri_tpu_torch.mcts.core import MCTS

    calls, real = [], MCTS.run

    def run(self, tree, num_sims, budget=None, ctx=None):
        calls.append((num_sims, budget, tree.terminal[:, 0].clone()))
        return real(self, tree, num_sims, budget, ctx)

    monkeypatch.setattr(MCTS, "run", run)
    return calls


@pytest.mark.parametrize("cell", sorted(READ))
def test_recorder_metrics_of_a_traced_run(cell, tiny, monkeypatch):
    calls = _searches(monkeypatch)
    res = RUN.run_cell(tiny(cell), 0.5, 1, lambda: None)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READ[cell]) <= set(m)
    for name in READ[cell]:
        assert math.isfinite(m[name]), name
        if name.startswith("descent_syncs"):
            assert m[name] >= 1
        elif "share" in name:
            assert 0 <= m[name] <= 100
        else:
            assert m[name] >= 0
    if cell.startswith("selfplay"):
        # the window's one move, then the traced one: the window's search
        sims, budget, term = calls[-2]
        active = int((budget.clamp(0, sims) * ~term).sum())
        assert m["active_lane_share.selfplay"] == pytest.approx(
            100.0 * active / (term.shape[0] * sims))
        assert m["active_lane_share.selfplay"] < 100


def test_readers_return_nothing_without_the_recorder(monkeypatch):
    real = builtins.__import__

    def no_telemetry(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "sayuri_tpu_torch" and "telemetry" in (fromlist or ()):
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_telemetry)
    for names in READ.values():
        for name in names:
            reader = RUN.load(RUN.ROOT / "port_bench" / "metrics" / f"{name}.py", "m")
            assert reader.read(None) is None
