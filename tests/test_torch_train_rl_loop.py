"""``python -m sayuri_tpu_torch.tools.rl_loop`` on the CPU: one round of
two 5x5 games (weightless: the weights dir starts empty), two training
steps, the checkpoint gated into the weights dir, which the self-play
pipe's next actor loads. Marked slow: the round's whole games (to the
45-move cap, the plain ladder twins at every root and record) take about
30 s on one CPU thread."""

import math

import pytest

from sayuri_tpu_torch.selfplay.pipe import SelfPlayPipe, newest_weights
from sayuri_tpu_torch.tools import rl_loop
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.slow
def test_rl_loop_round_trains_and_gates(tmp_path):
    argv = ["--workdir", str(tmp_path), "--rounds", "1", "--games-per-round", "2",
            "--parallel-games", "2", "--boardsize", "5", "--steps-per-round", "2",
            "--batch-size", "8", "--playouts", "10", "--fast-playouts", "5",
            "--channels", "16", "--blocks", "2", "--device", "cpu"]
    (first,) = rl_loop.main(argv)
    assert first["actor_weights"] is None and first["games"] == 2 and first["steps"] == 2
    assert math.isfinite(first["loss"])
    gated = sorted((tmp_path / "weights").glob("*.ckpt"))
    assert [p.name for p in gated] == ["sayuri-tpu-b2xc16-s2-c2-w2.ckpt"]
    assert len((tmp_path / "training.log").read_text().splitlines()) == 2
    pipe = SelfPlayPipe(str(tmp_path / "next"), boardsize=5, parallel_games=2,
                        weights_dir=str(tmp_path / "weights"), device="cpu")
    assert pipe.current_weights == newest_weights(tmp_path / "weights") == str(gated[0])
