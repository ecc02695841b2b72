"""A game of genmoves under --first-pass-bonus (seki and ownership at every
expansion, the bonus folded into the score mean) through the port's GTP
loop and the JAX package's on one seeded v5 weight file (a b2c16 net,
float32 on the CPU, 5x5), with the territory rule for its second half:
equal moves and scores, the analyze rows' words equal and their numbers
within 1e-4, the last trees' black_sb within 1e-6."""

import numpy as np
import pytest

from gtp_pair import NUMERIC, assert_same_answers, loop_pair, write_weights
from sayuri_tpu.mcts.core import SearchConfig as JConfig
from sayuri_tpu_torch.mcts.core import SearchConfig
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_first_pass_bonus_genmoves(tmp_path):
    """A game of genmoves under --first-pass-bonus (seki and ownership at
    every expansion) with the territory rule for its second half."""
    path = write_weights(tmp_path / "w.txt", 5, seed=3)
    kw = dict(boardsize=5, komi=2.5, playouts=16)
    jloop, tloop = loop_pair(path, **kw, search_cfg=None, max_nodes=40)
    jloop.agent.search_cfg = JConfig(max_nodes=40, first_pass_bonus=True)
    tloop.agent.search_cfg = SearchConfig(max_nodes=40, first_pass_bonus=True)
    for loop in (jloop, tloop):
        loop.agent._build(5, 2.5)   # the search with the new config
    script = ["clear_board"] + [f"genmove {'bw'[i % 2]}" for i in range(10)]
    script += ["rules japanese"] + [f"genmove {'bw'[i % 2]}" for i in range(6)]
    script += ["final_score", "kata-analyze b interval 0"]
    seen = 0.0
    for line in script:
        assert_same_answers(jloop, tloop, [line], numeric=NUMERIC)
        if line.startswith("genmove"):
            # the bonuses the search wrote, equal in both trees
            jsb = np.asarray(jloop.agent._tree.black_sb)
            tsb = tloop.agent._tree.black_sb.numpy()[:, : jsb.shape[1]]
            np.testing.assert_allclose(tsb, jsb, atol=1e-6, rtol=0, err_msg=line)
            seen = max(seen, float(np.abs(jsb).max()))
    assert seen > 0
