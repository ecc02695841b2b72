"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, check) on the CPU at a small size,
once sound and once with each fault a cell can have planted in the
measured program: a step that leaves the state unchanged, half of the
batch left out of the search, a prior or a value altered where the
evaluator produces it, a PUCT selection that takes the second-best child,
and in self-play a move altered where the actor picks it (to the next
vertex, or to another legal move) and a uniform target policy."""

import pytest

from port_bench import run as RUN

CELLS = ("search-b15c192-midgame", "selfplay-b6c96-19x19")


def _run(h):
    return RUN.run_cell(h, 0.5, 0, lambda: None)


def _unchanged_step(monkeypatch):
    from sayuri_tpu_torch.game.state import GoEnv

    real = GoEnv.step_batch_with_analysis

    def step(self, states, actions):
        new, out = real(self, states, actions)
        return new.replace(stones=states.stones), out

    monkeypatch.setattr(GoEnv, "step_batch_with_analysis", step)


def _half_batch(monkeypatch):
    import torch

    from sayuri_tpu_torch.mcts.core import MCTS

    real = MCTS.simulate

    def simulate(self, tree, sim_idx=0, active=None, ctx=None):
        b = tree.stats.shape[0]
        half = torch.arange(b, device=tree.stats.device) < b // 2
        return real(self, tree, sim_idx, half if active is None else active & half, ctx)

    monkeypatch.setattr(MCTS, "simulate", simulate)


def _altered_eval(monkeypatch):
    import torch

    from sayuri_tpu_torch.models import evaluator

    real = evaluator.make_eval_fn

    def make(*a, **k):
        fn = real(*a, **k)

        def eval_fn(states, ctx=None):
            ev = fn(states, ctx)
            pri = torch.roll(ev.priors, 1, dims=-1)
            pri = torch.where(ev.priors > 0, pri, 0.0)
            pri = pri / pri.sum(-1, keepdim=True).clamp(min=1e-12)
            return ev._replace(priors=pri, black_wl=1.0 - ev.black_wl)
        return eval_fn

    monkeypatch.setattr(evaluator, "make_eval_fn", make)


def _altered_move(monkeypatch):
    from sayuri_tpu_torch.mcts.core import MCTS

    real = MCTS.best_move

    def best_move(self, tree, allow_pass=None):
        return (real(self, tree, allow_pass) + 1) % (tree.num_actions - 1)

    monkeypatch.setattr(MCTS, "best_move", best_move)


def _legal_wrong_move(monkeypatch):
    import torch

    from sayuri_tpu_torch.mcts import gumbel as G
    from sayuri_tpu_torch.mcts.core import MCTS

    def other(pick):
        def move(self_or_mcts, tree, allow_pass=None):
            best = pick(self_or_mcts, tree, allow_pass)
            prior = tree.prior[:, 0].clone()
            prior[torch.arange(best.shape[0], device=best.device), best] = 0.0
            prior[:, -1] = 0.0
            return torch.where(prior.amax(-1) > 0, prior.argmax(-1), best)
        return move

    monkeypatch.setattr(G, "gumbel_move", other(G.gumbel_move))
    monkeypatch.setattr(MCTS, "best_move", other(MCTS.best_move))


def _uniform_target(monkeypatch):
    from sayuri_tpu_torch.selfplay.actor import SelfplayActor

    def target(self, tree, visits_dist, children_visits):
        legal = (tree.prior[:, 0] > 0).float()
        return legal / legal.sum(-1, keepdim=True).clamp(min=1.0)

    monkeypatch.setattr(SelfplayActor, "_target_policy", target)


def _second_best_child(monkeypatch):
    import torch

    from sayuri_tpu_torch.mcts.core import MCTS

    real = MCTS._argmax_prior_tiebreak

    def pick(scores, priors):
        best = real(scores, priors)
        rest = scores.clone()
        rest[torch.arange(best.shape[0], device=best.device), best] = -torch.inf
        return torch.where(torch.isfinite(rest).any(-1), rest.argmax(-1), best)

    monkeypatch.setattr(MCTS, "_argmax_prior_tiebreak", staticmethod(pick))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    assert _run(tiny(cell))["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch, _altered_eval])
def test_fault_is_caught(cell, fault, tiny, monkeypatch):
    fault(monkeypatch)
    res = _run(tiny(cell))
    assert not res["correct"], res["limits"]


@pytest.mark.parametrize("fault", [_altered_move, _legal_wrong_move, _uniform_target])
def test_selfplay_fault_is_caught(fault, tiny, monkeypatch):
    fault(monkeypatch)
    res = _run(tiny("selfplay-b6c96-19x19"))
    assert not res["correct"], res["limits"]


def test_second_best_child_is_caught(tiny, monkeypatch):
    _second_best_child(monkeypatch)
    res = _run(tiny("search-b15c192-midgame"))
    assert not res["correct"], res["limits"]
