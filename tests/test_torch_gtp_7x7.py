"""The port's GTP loop against the JAX package's at 7x7 on one seeded v5
weight file (a b2c16 net, float32 on the CPU): a game of genmoves with
tree reuse on and off, undo, the analyze rows and the score, then the
handicap commands (fixed_handicap, set_free_handicap, get_handicap: the
handicap count and its komi penalty). Answers are equal string for string;
the analyze rows' words are equal and their numbers agree within 1e-4
(lz rows: their integer 1/10000 units within one)."""

import jax
import pytest

from gtp_pair import NUMERIC, assert_same_answers, loop_pair, write_weights
from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu_torch.game.state import GoEnv
from test_torch_board import assert_states_equal
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    path = write_weights(tmp_path_factory.mktemp("w") / "b2c16-7.txt", 7, seed=7)
    return {7: loop_pair(path, boardsize=7, komi=6.5, playouts=10, max_nodes=38, chunk=4)}


def test_game_script(pairs):
    jloop, tloop = pairs[7]
    script = ["clear_board", "komi 5.5", "play b D4", "genmove w", "genmove b", "genmove w",
              "undo", "genmove w", "sayuri-setoption name reuse tree value false",
              "genmove b", "sayuri-setoption name reuse tree value true", "genmove w",
              "genmove b", "kata-analyze w 0", "lz-analyze w interval 0 maxmoves 3", "final_score",
              "printsgf", "showboard"]
    assert_same_answers(jloop, tloop, script, numeric=NUMERIC)


def test_handicap_script(pairs):
    jloop, tloop = pairs[7]
    script = ["clear_board", "fixed_handicap 2", "get_handicap", "showboard", "final_score",
              "genmove w", "clear_board", "set_free_handicap C3 E5 C5", "get_handicap",
              "gogui-rules_side_to_move", "final_score", "genmove w", "printsgf",
              "fixed_handicap 12", "clear_board", "get_handicap"]
    assert_same_answers(jloop, tloop, script, numeric=NUMERIC)




def test_new_batch_with_handicap_matches_new_state():
    """GoEnv.new_batch(1, handicap=k) stands for the JAX package's
    single-game new_state(handicap=k): the same state, the same komi
    penalty under the area rule."""
    jenv, env = JEnv(n=7), GoEnv(n=7)
    js = jenv.new_state(komi=0.5, handicap=3)
    ts = env.new_batch(1, komi=0.5, handicap=3, device="cpu")
    assert_states_equal(jax.tree.map(lambda x: x[None], js), ts)
    assert float(jenv.komi_with_penalty(js)) == float(env.komi_with_penalty(ts)[0]) == 3.5
