"""The port's `--mode gtp` and `--mode benchmark` entry points and the GTP
loop's own behaviour, on the CPU:

- `main(["--mode", "gtp", ...], device="cpu")` with a stdin script at 5x5
  answers every command (with a v5 weight file, the analyze stream and
  the genmove_analyze play line included);
- `--mode benchmark --benchmark-query bg:2:8` prints its line;
- the port's Options parse configs/gtp-p400.txt and a flag-heavy command
  line into the same Agent and loop arguments as the JAX package's
  run_gtp builds (an Agent of each package compared attribute by
  attribute);
- `--patterns` raises;
- an exception raised in the kernel wrappers (sayuri_tpu_torch/ops) or a
  CUDA error inside a handler is not turned into a "?" answer, while a bad
  vertex still is;
- the commands that the JAX comparison files leave out (the gogui rating
  family, debug probes, the book, openings, the self-play probes and the
  training buffer, netbench, benchmark, the clock) answer.
"""

import io
import sys
from pathlib import Path

import pytest
import torch

from gtp_pair import write_weights
from sayuri_tpu.config import Options as JOptions
from sayuri_tpu.gtp.engine import Agent as JAgent
from sayuri_tpu_torch import __main__ as CLI
from sayuri_tpu_torch.config import Options
from sayuri_tpu_torch.gtp.loop import GtpLoop
from sayuri_tpu_torch.ops import analysis as TA
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("w") / "b2c16-5.txt", 5, seed=1)


def _run_gtp(monkeypatch, argv, script):
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(l + "\n" for l in script)))
    monkeypatch.setattr(sys, "stdout", out)
    CLI.main(["--mode", "gtp"] + argv, device="cpu")
    return out.getvalue()


def _answers(text):
    """The answer lines of a GTP transcript (a stream's first line is its
    answer line)."""
    return [line for line in text.split("\n") if line[:1] in ("=", "?")]


def test_gtp_mode_answers_a_script(monkeypatch, weights):
    script = ["1 name", "boardsize 5", "clear_board", "komi 4.5", "play b C3", "genmove w",
              "showboard", "kata-analyze b 1", "lz-genmove_analyze b 1", "undo",
              "final_score", "final_status_list dead", "printsgf", "sayuri-raw_nn avg",
              "2 quit"]
    text = _run_gtp(monkeypatch, ["--boardsize", "5", "--playouts", "8",
                                  "--weights", weights], script)
    answers = _answers(text)
    assert len(answers) == len(script) and all(a.startswith("=") for a in answers)
    assert answers[0] == "=1 sayuri-tpu" and answers[-1].startswith("=2")
    # the genmove_analyze stream ends with its play line
    stream = text.split("\n=\n")[-1]
    assert "info move" in stream and "\nplay " in stream


def test_gtp_mode_weightless_and_benchmark_mode(monkeypatch, capsys):
    text = _run_gtp(monkeypatch, ["--boardsize", "5", "--playouts", "4"],
                    ["genmove b", "genmove w", "is_legal b Z9", "bogus", "quit"])
    assert [a[0] for a in _answers(text)] == ["=", "=", "?", "?", "="]
    monkeypatch.undo()
    rates = CLI.main(["--mode", "benchmark", "--boardsize", "5", "--benchmark-query",
                      "bg:2:8"], device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("batch 2 x 8 playouts: ") and "elo-effect" in out
    assert len(rates) == 1 and rates[0] > 0


_AGENT_ATTRS = ("playouts", "ponder_enabled", "ponder_factor", "kldgain_per_node",
                "kldgain_interval", "friendly_pass", "capture_all_dead", "use_rollout",
                "policy_temp", "root_policy_temp", "suppress_pass_factor", "use_stm_winrate",
                "use_optimistic_policy", "timemanage", "symm_pruning", "reuse_tree", "size",
                "komi", "seed", "chunk")
FLAGS = ["--boardsize", "7", "--komi", "6.5", "--playouts", "33", "--ponder",
         "--ponder-factor", "9", "--kldgain-per-node", "0.001", "--kldgain-interval", "50",
         "--friendly-pass", "--capture-all-dead", "--policy-temp", "0.9",
         "--root-policy-temp", "1.3", "--suppress-pass-factor", "0.2", "--use-stm-winrate",
         "--use-optimistic-policy", "--timemanage", "fast", "--symm-pruning",
         "--no-reuse-tree", "--first-pass-bonus", "--cpuct-init", "0.7", "--no-cache",
         "--lcb-reduction", "0.1", "--resign-threshold", "0.05", "--const-time", "3",
         "--lag-buffer", "0.5", "--kgs-hint", "hi", "--use-rollout"]


def _jax_agent(opts):
    """The Agent the JAX package's run_gtp builds from `opts` (its kwargs,
    without weights)."""
    g = opts.get
    agent = JAgent(
        boardsize=g("boardsize"), komi=g("komi"), playouts=g("playouts"),
        search_cfg=opts.search_config(), use_rollout=g("use_rollout"), ponder=g("ponder"),
        ponder_factor=g("ponder_factor"), kldgain_per_node=g("kldgain_per_node"),
        kldgain_interval=g("kldgain_interval"), policy_temp=g("policy_temp"),
        root_policy_temp=g("root_policy_temp"),
        suppress_pass_factor=g("suppress_pass_factor"),
        use_stm_winrate=g("use_stm_winrate"),
        use_optimistic_policy=g("use_optimistic_policy"), timemanage=g("timemanage"),
        symm_pruning=g("symm_pruning"), friendly_pass=g("friendly_pass"),
        capture_all_dead=g("capture_all_dead"))
    agent.reuse_tree = g("reuse_tree")
    return agent


@pytest.mark.parametrize("argv", [["--config", str(ROOT / "configs/gtp-p400.txt")], FLAGS],
                         ids=["gtp-p400", "flags"])
def test_options_give_the_jax_agent(argv):
    jopts, topts = JOptions().parse_args(argv), Options().parse_args(argv)
    topts.check_gtp_flags()
    want, loop = _jax_agent(jopts), CLI.build_gtp_loop(topts, device="cpu")
    got = loop.agent
    for k in _AGENT_ATTRS:
        assert getattr(want, k) == getattr(got, k), k
    jcfg, tcfg = want.search_cfg, got.search_cfg
    for k in tcfg.__dataclass_fields__:
        assert getattr(jcfg, k) == getattr(tcfg, k), k
    for k, opt in (("const_time", "const_time"), ("lag_buffer_floor", "lag_buffer"),
                   ("resign_threshold", "resign_threshold"), ("kgs_hint", "kgs_hint")):
        assert getattr(loop, k) == jopts.get(opt), k


def test_patterns_raise():
    with pytest.raises(ValueError, match="--patterns.*pattern-gammas"):
        CLI.main(["--mode", "gtp", "--patterns", "x.txt"], device="cpu")
    with pytest.raises(ValueError, match="--gammas-policy-factor"):
        Options().parse_args(["--gammas-policy-factor", "0.5"]).check_gtp_flags()


def test_kernel_errors_pass_through(monkeypatch):
    loop = GtpLoop(boardsize=5, playouts=4, device="cpu")
    assert loop.execute("play b Z9")[0] is False          # a bad vertex: "?"

    def broken(*args):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(TA, "board_analysis_plain", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        loop.execute("final_score")
    monkeypatch.undo()
    assert loop.execute("final_score") == (True, "W+7.5")

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(loop.agent, "final_score_str", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        loop.run(io.StringIO("name\nfinal_score\nname\n"), io.StringIO())


def test_other_commands_answer(tmp_path, weights):
    from sayuri_tpu_torch.game import sgf as SGF
    from sayuri_tpu_torch.models import weights_io as TW

    _, net = TW.load_checkpoint_for_inference(weights)
    loop = GtpLoop(boardsize=5, komi=4.5, playouts=6, max_nodes=20, net=net, device="cpu")
    sgf_dir = tmp_path / "sgf"
    sgf_dir.mkdir()
    (sgf_dir / "g.sgf").write_text(SGF.game_to_sgf(19, 7.5, [(0, 60), (1, 300)]))
    script = [
        "play b C3", "gogui-wdl_rating", "gogui-policy_rating optimistic",
        "gogui-policy_heatmap", "gogui-ownership_heatmap", "gogui-ownership_influence 0",
        "gogui-ownership_influence 6", "gogui-rank_selection", "debug_search 6",
        "debug_moves C4 pass", "netbench 2", "benchmark 4", "gogui-book_rating",
        f"genbook {sgf_dir} {tmp_path / 'book.json'}", f"loadbook {tmp_path / 'book.json'}",
        "time_settings 30 5 1", "kgs-time_settings byoyomi 20 5 2", "time_left w 10 1",
        "genmove w", "clear_board", f"genopenings {tmp_path / 'op'} 1 2", "kgs-chat",
        "kgs-game_over",
        "sayuri-setoption name cache size value 64", "sayuri-setoption name lag buffer value 1",
        "sayuri-setoption name gammas policy factor value 0.5", "genmove b",
    ]
    for line in script:
        ok, body = loop.execute(line)
        if line.startswith("sayuri-setoption name gammas"):
            assert not ok and "not supported" in body
        else:
            assert ok, (line, body)
    assert loop.agent.search_cfg.nn_cache_size == 64
    # the self-play probes, weightless (such a game ends by two passes)
    loop = GtpLoop(boardsize=5, komi=4.5, playouts=6, max_nodes=20, device="cpu")
    buf = tmp_path / "buf.txt"
    for line, want in (("selfplay-genmove b", True), (f"dump_training_buffer {buf}", False),
                       ("clear_training_buffer", True), ("selfplay", True),
                       (f"dump_training_buffer {buf}", True)):
        assert loop.execute(line)[0] == want, line
    assert loop.agent.game_over()
    lines = (tmp_path / "buf.txt").read_text().split("\n")[:-1]
    assert lines and len(lines) % 53 == 0 and lines[:2] == ["2", "0"]


def test_bench_gtp_runs_the_config():
    """bench gtp on the CPU at a cut size (9x9, 8 playouts, the config's
    other settings) on the seeded v5 file: one warm-up genmove, then the
    timed ones with tree reuse and one without, each a legal answer,
    their seconds and playouts."""
    from sayuri_tpu_torch import bench

    res = bench.bench_gtp(2, fresh=1, device="cpu",
                          argv=["--boardsize", "9", "--playouts", "8"])
    assert len(res["seconds"]) == len(res["moves"]) == 2 and res["median_s"] > 0
    assert res["playouts"] == [8, 8] and res["playouts_per_s"] > 0
    assert res["s_per_playout"] == pytest.approx(1 / res["playouts_per_s"])
    assert res["fresh_playouts"] == [8] and res["fresh_median_s"] > 0
    agent = res["loop"].agent
    assert agent.size == 9 and agent.has_net and not agent.reuse_tree
    assert [c for c, _ in agent.moves] == [0, 1, 0]
