"""The port's 43 encoder planes, with the ladder planes of
``ladder_planes_batch``, and its legal mask against the reference-generated
goldens (tools/gen_goldens.py): all 76 records at 9x9 and a stride of the
19x19 records, replayed through the port's GoEnv. The tolerance is the
goldens' 2-decimal dump (atol 6e-3, as tests/test_goldens.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sayuri_tpu_torch.game.ladder import ladder_planes_batch
from sayuri_tpu_torch.game.state import GoEnv, GoState
from sayuri_tpu_torch.models.encoder import encode
from sayuri_tpu_torch.ops.analysis import board_analysis
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN_DIR = Path(__file__).parent / "goldens"


def replay(env, records, komi):
    """All records' moves ("pass" or a flat vertex) in one batch; a lane
    stops moving after its last move."""
    b, n = len(records), env.n
    s = env.new_batch(b, komi=komi, device="cpu")
    moves = [r["moves"] for r in records]
    for t in range(max(len(m) for m in moves)):
        active = torch.tensor([t < len(m) for m in moves])
        acts = torch.tensor([n * n if t >= len(m) or m[t] == "pass" else int(m[t])
                             for m in moves], dtype=torch.int32)
        new = env.step(s, acts)
        s = GoState(**{
            k: torch.where(active.view((b,) + (1,) * (v.ndim - 1)), v, getattr(s, k))
            for k, v in new.fields().items()
        })
    return s


@pytest.mark.parametrize("size,stride", [(9, 1), (19, 3)])
def test_goldens_all_planes(size, stride):
    data = json.load(open(GOLDEN_DIR / f"go_goldens_{size}.json"))
    records = data["records"][::stride]
    env = GoEnv(n=size)
    s = replay(env, records, data["komi"])
    legal = env.legal_action_mask(s)
    ladders = ladder_planes_batch(s.stones, s.size, s.ko)
    ana = board_analysis(s.stones, s.size, s.ko, s.to_move)
    planes = encode(env, s, ladders, ana["libs"], ana["safe"],
                    ana["score_ownership"]).permute(0, 3, 1, 2).numpy()
    marked = 0
    for i, rec in enumerate(records):
        assert int(s.to_move[i]) == "bw".index(rec["to_move"]), f"rec {i}"
        np.testing.assert_array_equal(legal[i, : size * size].numpy(),
                                      np.array(rec["legal"], bool),
                                      err_msg=f"size {size} rec {i} legality")
        ref = np.array(rec["planes"], np.float32)
        marked += int(ref[33:37].sum() > 0)
        for p in range(43):
            np.testing.assert_allclose(planes[i, p], ref[p], atol=6e-3,
                                       err_msg=f"size {size} rec {i} plane {p}")
    assert marked >= len(records) // 2   # ladder marks are present
