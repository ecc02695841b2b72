"""The pattern gammas in the port's GTP engine, on the CPU at 5x5:

- ``genpatterns``, ``gogui-gammas_heatmap``, ``gogui-gammas_rating`` and
  the ``patterns file`` / ``gammas policy factor`` options of
  sayuri-setoption answer string for string as the JAX GtpLoop's
  (weightless: no JAX search runs), and the two genpatterns files are
  byte-identical;
- ``--mode gtp --patterns F --gammas-policy-factor 0.5`` loads the table
  and mixes it in the evaluator; ``python -m sayuri_tpu_torch.gtp.loop``'s
  ``main`` answers a script;
- a genmove with gammas is legal, the root priors are the evaluator's
  mixed priors, ``refresh_gammas`` turns the mix off at factor 0, and a
  table set on the Agent without a refresh is mixed into the root's
  priors on the host."""

import io
import sys

import numpy as np
import pytest
import torch

from gtp_pair import answer, write_weights
from sayuri_tpu.gtp.loop import GtpLoop as JLoop
from sayuri_tpu_torch import __main__ as CLI
from sayuri_tpu_torch.config import Options
from sayuri_tpu_torch.gtp import loop as TL
from sayuri_tpu_torch.gtp.loop import GtpLoop
from sayuri_tpu_torch.models import weights_io as TW
from sayuri_tpu_torch.pattern.gammas import GammasDict
from test_torch_pattern import write_sgfs
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 5


@pytest.fixture(scope="module")
def patterns(tmp_path_factory):
    """A dist-3 patterns file trained by the port's genpatterns on 5x5
    SGFs, and the SGF directory."""
    d = tmp_path_factory.mktemp("pat")
    write_sgfs(d / "sgf", n=N, games=3, moves=14, seed=1)
    loop = GtpLoop(boardsize=N, playouts=4, device="cpu")
    ok, body = loop.execute(f"genpatterns {d / 'sgf'} {d / 'g.json'}")
    assert ok and body.endswith(" gammas"), body
    return d / "g.json", d / "sgf"


def test_gammas_commands_answer_as_jax(patterns, tmp_path):
    _, sgf = patterns
    jloop = JLoop(boardsize=N, komi=7.0, playouts=4)
    tloop = GtpLoop(boardsize=N, komi=7.0, playouts=4, device="cpu")
    files = {}
    for tag, loop in (("jax", jloop), ("port", tloop)):
        files[tag] = tmp_path / f"{tag}.json"
        assert loop.execute(f"genpatterns {sgf} {files[tag]} 1")[0]
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    script = ["genpatterns x", "gogui-gammas_heatmap", "gogui-gammas_rating",
              f"sayuri-setoption name patterns file value {files['jax']}",
              "play b C3", "play w B2", "gogui-gammas_heatmap", "gogui-gammas_rating",
              "sayuri-setoption name gammas policy factor value 0.5", "gogui-gammas_rating",
              "sayuri-setoption name gammas policy factor value 2",
              f"sayuri-setoption name patterns file value {tmp_path / 'missing.json'}",
              "play b pass", "gogui-gammas_heatmap", "gogui-gammas_rating"]
    for line in script:
        assert answer(jloop, line) == answer(tloop, line), line
    assert tloop.agent.gammas_policy_factor == jloop.agent.gammas_policy_factor == 1.0
    assert tloop.agent.gammas.table == jloop.agent.gammas.table


def test_cli_reads_gammas_flags(patterns, monkeypatch):
    f, _ = patterns
    argv = ["--boardsize", str(N), "--playouts", "4", "--patterns", str(f),
            "--gammas-policy-factor", "0.5"]
    loop = CLI.build_gtp_loop(Options().parse_args(argv), device="cpu")
    assert loop.agent.gammas.table == GammasDict.load(f).table
    assert loop.agent.gammas_policy_factor == 0.5 and loop.agent._gammas_in_eval
    script = ["genmove b", "gogui-gammas_rating",
              "sayuri-setoption name gammas policy factor value 0", "genmove w", "quit"]
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(l + "\n" for l in script)))
    monkeypatch.setattr(sys, "stdout", out)
    CLI.main(["--mode", "gtp"] + argv, device="cpu")
    answers = [line for line in out.getvalue().split("\n") if line[:1] in ("=", "?")]
    assert len(answers) == len(script) and all(a[0] == "=" for a in answers), answers


def test_loop_main_answers(monkeypatch):
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO("name\nboardsize 5\ngenmove b\nquit\n"))
    monkeypatch.setattr(sys, "stdout", out)
    loop = TL.main(["--boardsize", "5", "--komi", "6.5", "--playouts", "4"], device="cpu")
    answers = [line for line in out.getvalue().split("\n") if line[:1] in ("=", "?")]
    assert answers[0] == "= sayuri-tpu" and len(answers) == 4
    assert all(a[0] == "=" for a in answers) and loop.agent.komi == 6.5


def test_genmove_mixes_gammas_into_the_root(patterns, tmp_path):
    f, _ = patterns
    _, net = TW.load_checkpoint_for_inference(write_weights(tmp_path / "w.txt", N, seed=3))
    agent = GtpLoop(boardsize=N, komi=7.0, playouts=8, net=net, patterns_file=str(f),
                    gammas_policy_factor=0.5, device="cpu").agent
    assert agent._gammas_in_eval
    agent.play(0, 12)
    legal = agent.legal_mask()
    mv, _ = agent.genmove(1)
    assert legal[mv]

    def root_priors():
        agent._drop_tree()
        tree, _ = agent.think(playouts=2)
        return tree, tree.prior[0, 0].clone()

    _, mixed = root_priors()
    want = agent.eval_fn(agent.state, agent._ladders(agent.state)).priors[0]
    want = torch.where(~agent._superko_mask()[0], want, 0.0)
    np.testing.assert_allclose(mixed.numpy(), (want / want.sum()).numpy(), atol=1e-6)

    agent.gammas_policy_factor = 0.0
    agent.refresh_gammas()
    assert not agent._gammas_in_eval
    _, plain = root_priors()
    assert not torch.allclose(plain, mixed)

    # a table set without a refresh: mixed into the root on the host, with
    # the root evaluation's ownership (the tree's average moves on with
    # the search)
    agent.gammas_policy_factor = 0.5
    _, host = root_priors()
    ev = agent.eval_fn(agent.state, agent._ladders(agent.state))
    own = ev.black_ownership[0].numpy() * (1 if agent.to_move() == 0 else -1)
    p0 = plain.numpy().astype(np.float64)
    gp = agent.gammas.policy(agent.stones(), N, agent.to_move(), p0 > 0,
                             last_move=agent.moves[-1][1], ownership=own)
    exp = p0.copy()
    exp[:N * N] = 0.5 * p0[:N * N] + 0.5 * (1 - p0[N * N]) * gp[:N * N]
    np.testing.assert_allclose(host.numpy(), exp / exp.sum(), atol=1e-6)
    assert ((host > 0) == (plain > 0)).all() and not torch.allclose(host, plain)
