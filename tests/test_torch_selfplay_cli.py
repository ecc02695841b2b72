"""The port's option store and `--mode selfplay` entry point:

- its Options parse the repo's three configs/*.txt (and flag spellings:
  aliases, --no-X, --no-cache, --cache-memory-mib) into the same search and
  self-play fields as the JAX package's Options;
- a flag the mode does not read yet raises, and so does an unknown mode;
- `--mode selfplay` at 5x5 on the CPU writes tdata / vdata chunks, SGFs
  and net_queries, with a v5 weight file in --weights-dir;
- fair komi set through the randomizer (a handicap query) gives the JAX
  package's komi and positions.
"""

import gzip
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.config import Options as JOptions
from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.selfplay import randomize as JR
from sayuri_tpu_torch import __main__ as CLI
from sayuri_tpu_torch.config import Options
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.models import weights_io as TW
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.selfplay import randomize as R
from test_torch_board import assert_states_equal
from test_torch_randomize import _jax_key, _jax_onehot_eval, _torch_onehot_eval
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p) for p in (ROOT / "configs").glob("*.txt"))
EXTRA = [
    ["--noise", "--reduce-playouts", "12", "--reduce-playouts-prob", "0.5"],
    ["--no-cpuct-dynamic", "--no-cache", "--gumbel-prom-visits", "3"],
    ["--cache-memory-mib", "4", "--boardsize", "9", "--ci-alpha", "0.001"],
]


def _fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


@pytest.mark.parametrize("argv", [["--config", c] for c in CONFIGS] + EXTRA)
def test_options_match_jax(argv):
    assert len(CONFIGS) == 3
    want, got = JOptions().parse_args(argv), Options().parse_args(argv)
    js, ts = _fields(want.search_config()), _fields(got.search_config())
    assert set(ts) <= set(js)
    assert {k: js[k] for k in ts} == ts
    assert _fields(want.selfplay_config()) == _fields(got.selfplay_config())
    for k in ("mode", "boardsize", "komi", "parallel_games", "num_games", "selfplay_query",
              "weights_dir", "target_directory", "handicap_fair_komi_prob"):
        assert want.get(k) == got.get(k), k


def test_unsupported_flags_and_modes_raise(tmp_path):
    """A flag a mode does not read raises (the gtp and benchmark modes are
    ported; the first-pass bonus reaches the search config); an unknown
    mode or option raises."""
    with pytest.raises(ValueError, match="--policy-temp"):
        CLI.main(["--mode", "selfplay", "--policy-temp", "0.5"], device="cpu")
    assert Options().parse_args(["--first-pass-bonus"]).search_config().first_pass_bonus
    with pytest.raises(ValueError, match="--patterns"):
        CLI.main(["--mode", "gtp", "--patterns", "p.txt"], device="cpu")
    with pytest.raises(ValueError, match="--num-games"):
        CLI.main(["--mode", "benchmark", "--num-games", "3"], device="cpu")
    with pytest.raises(SystemExit, match="unknown mode"):
        CLI.main(["--mode", "train"], device="cpu")
    with pytest.raises(ValueError, match="unknown option"):
        Options().parse_args(["--no-such-flag", "1"])


def test_selfplay_mode_writes_chunks_sgfs_and_queries(tmp_path):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    net = SayuriNet(NetConfig(boardsize=5, residual_channels=8,
                              stack=("ResidualBlock-SE",))).init_random(3)
    TW.export_reference_weights(net, str(wdir / "net.txt"))
    out = tmp_path / "out"
    pipe = CLI.main(["--mode", "selfplay", "--boardsize", "5", "--playouts", "3",
                     "--fastsearch-playouts", "2", "--fastsearch-playouts-prob", "0.5",
                     "--gumbel", "--parallel-games", "2", "--num-games", "2",
                     "--selfplay-query", "srs:territory", "--weights-dir", str(wdir),
                     "--target-directory", str(out)], device="cpu")
    assert pipe.games_done == 2 and pipe.current_weights == str(wdir / "net.txt")
    chunks = sorted(out.glob("[tv]data/*/*.txt.gz"))
    assert len(chunks) == pipe.last_round["chunks"] > 0
    lines = sum(gzip.open(c, "rt").read().count("\n") for c in chunks)
    assert lines == 53 * pipe.last_round["kept_records"] > 0
    assert len(list((out / "sgf").glob("*.sgf"))) == 2
    queries = list((out / "net_queries").glob("*.txt"))
    assert len(queries) == 1
    done, total = map(int, queries[0].read_text().split())
    assert done == 0 and total > 0
    # srs:territory puts both rules in the pool: where a lane drew the
    # territory rule, the helper playout ran
    if pipe.last_round["territory_lanes"]:
        assert pipe.last_round["helper_steps"] > 0


def test_fair_komi_search_matches_jax():
    """A handicap query with fair komi on every handicap lane: the komi the
    randomizer sets from the search's score lead (here a fixed function of
    the position, the same on both sides) equals the JAX package's."""
    kw = dict(komi_stddev=1.0, handicap_fair_komi_prob=0.5)
    queries = ["bkp:9:7.5:1.0", "bhp:9:4:0.8"]
    jenv, tenv = JEnv(n=9), GoEnv(n=9)

    def lead(s):
        return 0.5 * s.move_count - 1.25 * s.handicap + 0.75 * s.to_move

    want = JR.GameRandomizer(jenv, JR.parse_queries(queries, **kw), _jax_onehot_eval(jenv),
                             fair_komi_search=lead).prepare(12, _jax_key(4))
    got = R.GameRandomizer(tenv, R.parse_queries(queries, **kw), _torch_onehot_eval(tenv),
                           fair_komi_search=lead).prepare(12, 4, device="cpu")
    assert_states_equal(want, got, "fair komi")
    plain = R.GameRandomizer(tenv, R.parse_queries(queries, **kw),
                             _torch_onehot_eval(tenv)).prepare(12, 4, device="cpu")
    moved = got.komi != plain.komi
    assert bool(moved.any()) and bool((got.handicap[moved] > 0).all())
    np.testing.assert_array_equal(np.asarray(want.komi), got.komi.numpy())
    assert jnp.asarray(want.handicap).max() > 0 and torch.equal(got.handicap, plain.handicap)
