"""The port's training data and settings against the JAX package's:

chunks written by the port's self-play (5x5 games, read into a 7x7
buffer) go through both packages' ``dataset`` modules, which must give
equal ``wrap_sample`` outputs under all eight symmetries, the same
``SurpriseSampler`` decisions, the same ``select_window_chunks`` and, under
one seed, ``ChunkLoader`` batches equal byte for byte; ``load_setting`` on
the same JSON gives the same fields and the same errors.

On the same chunks, ``python -m sayuri_tpu_torch.tools.train_worker`` runs
on the CPU: it stores a checkpoint, v5 and SWA v5 weights and its logs, the
v5 file loads back with the trainer's eval-mode outputs, a second run
resumes; the checkpoint it stores is what the self-play pipe reloads and
what ``--mode gtp --weights x.ckpt`` plays with.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from sayuri_tpu.train import dataset as JD
from sayuri_tpu.train import setting as JS
from sayuri_tpu_torch import __main__ as CLI
from sayuri_tpu_torch.config import Options
from sayuri_tpu_torch.mcts.core import SearchConfig
from sayuri_tpu_torch.selfplay.actor import SelfplayConfig
from sayuri_tpu_torch.models.weights_io import load_checkpoint_for_inference
from sayuri_tpu_torch.selfplay.pipe import SelfPlayPipe
from sayuri_tpu_torch.tools import train_worker
from sayuri_tpu_torch.train import dataset as TD
from sayuri_tpu_torch.train import setting as TS
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def chunks(tmp_path_factory, one_torch_thread):  # noqa: F811
    """A weightless 5x5 self-play round of the port: 2 games of 15 moves,
    every record kept, both rules in the pool (the plain ladder twins that
    encode each record set its cost on the CPU)."""
    out = tmp_path_factory.mktemp("selfplay")
    pipe = SelfPlayPipe(str(out), boardsize=5, parallel_games=2,
                        search_cfg=SearchConfig(max_nodes=24, gumbel=True),
                        sp_cfg=SelfplayConfig(playouts=20, fastsearch_playouts=10,
                                              fastsearch_playouts_prob=0.0,
                                              max_moves_factor=0.6),
                        queries=["srs:area:territory"], device="cpu")
    pipe.play_round()
    files = sorted(out.glob("[tv]data/*/*.txt.gz"))
    assert len(files) == pipe.last_round["chunks"] == 2
    return out, files


def _samples(pkg, files):
    return [s for f in files for s in pkg.read_chunk(f)]


def test_chunks_parse_alike(chunks):
    _, files = chunks
    want, got = _samples(JD, files), _samples(TD, files)
    assert len(got) == len(want) == 30
    for w, g in zip(want, got):
        assert g.kld == w.kld and g.lines == w.lines
        g.parse(), w.parse()
        for k in TD.Sample.__slots__:
            np.testing.assert_array_equal(np.asarray(getattr(g, k)), np.asarray(getattr(w, k)))
    bad = list(got[0].lines)
    bad[0] = "3"
    with pytest.raises(ValueError, match="data version 3"):
        TD.Sample(bad).parse()


@pytest.mark.parametrize("symm", range(8))
def test_wrap_sample_matches_jax(chunks, symm):
    _, files = chunks
    for w, g in zip(_samples(JD, files), _samples(TD, files)):
        w.parse().apply_symmetry(symm)
        g.parse().apply_symmetry(symm)
        wp, wt = JD.wrap_sample(w, 7)
        gp, gt = TD.wrap_sample(g, 7)
        assert gp.tobytes() == wp.tobytes() and gp.shape == (7, 7, 43)
        assert gt.keys() == wt.keys()
        for k in wt:
            assert np.asarray(gt[k]).tobytes() == np.asarray(wt[k]).tobytes(), k
        assert not gp[5:, :, :].any() and not gp[:, 5:, :].any()


def test_surprise_sampler_matches_jax(chunks):
    import random

    _, files = chunks
    klds = [s.kld for s in _samples(TD, files)] * 20
    for rate, factor, vbuf in ((4, 0.5, 64), (16, 0.0, 400), (1, 0.5, 8)):
        js = JD.SurpriseSampler(rate, factor, vbuf, rng=random.Random(3))
        ts = TD.SurpriseSampler(rate, factor, vbuf, rng=random.Random(3))
        want, got = [js(k) for k in klds], [ts(k) for k in klds]
        assert got == want and ts.running_kld_mean == js.running_kld_mean
        assert rate == 1 or 0 < sum(got) < len(got)


def test_select_window_chunks_matches_jax(chunks):
    out, _ = chunks
    for kw in ({}, dict(c=2, alpha=0.5, beta=0.5), dict(c=1, max_chunks=2)):
        assert TD.select_window_chunks(str(out), **kw) == JD.select_window_chunks(str(out), **kw)
    assert [TD.compute_window_size(n) for n in (0, 1, 5000, 250000)] == \
        [JD.compute_window_size(n) for n in (0, 1, 5000, 250000)]


@pytest.mark.parametrize("loop", [False, True], ids=["one_pass", "looping"])
def test_chunk_loader_batches_equal_byte_for_byte(chunks, loop):
    _, files = chunks
    kw = dict(nn_size=7, batch_size=4, down_sample_rate=2 if loop else 1,
              policy_surprise_factor=0.5, shuffle_capacity=8, virtual_buffsize=32, loop=loop,
              seed=11)
    jl, tl = JD.ChunkLoader(files, **kw), TD.ChunkLoader(files, **kw)
    try:
        n = 0
        for (wp, wt), (gp, gt) in zip(jl, tl):
            assert gp.tobytes() == wp.tobytes()
            for k in wt:
                assert gt[k].tobytes() == wt[k].tobytes(), k
            n += 1
            if n == 12:
                break
    finally:
        jl.close()
        tl.close()
    assert n >= 3 and not tl.thread.is_alive()


def test_chunk_loader_raises_a_worker_error(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("\n".join(["9"] + ["0"] * 51 + ["0.5"]) + "\n")
    loader = TD.ChunkLoader([bad], nn_size=7, batch_size=1, down_sample_rate=1,
                            shuffle_capacity=1, loop=False)
    with pytest.raises(ValueError, match="data version 9"):
        list(loader)
    loader.close()


SETTING = {
    "NeuralNetwork": {
        "NNType": "Residual", "MaxBoardSize": 9, "InputChannels": 43,
        "ResidualChannels": 64, "PolicyHeadChannels": 16, "ValueHeadChannels": 16,
        "Stack": ["ResidualBlock", "ResidualBlock-SE"], "SeRatio": 4,
        "PolicyHeadType": {"Type": "Normal"}, "Activation": "ReLU",
    },
    "Train": {
        "UseFp16": True, "Optimizer": "Adam", "BatchSize": 128, "MacroFactor": 2,
        "WeightDecay": 3e-5, "LearningRateSchedule": [[0, 0.02], [500, 0.002]],
        "WarmUpSteps": 100, "SwaMaxCount": 8, "SwaSteps": 50, "SoftLossWeight": 0.2,
        "RenormMaxR": 2, "RenormMaxD": 1.5, "StepsPerEpoch": 200, "ValidationSteps": 10,
        "VerboseSteps": 20, "MaxStepsPerRunning": 4000, "Workers": 2, "BufferSize": 4096,
        "DownSampleRate": 8, "NumberChunks": 100, "ChunksIncreasingC": 50,
        "ChunksIncreasingAlpha": 0.7, "PolicySurpriseFactor": 0.3,
        "TrainDirectory": "tdata", "ValidationDirectory": "vdata", "StorePath": "store",
    },
}


def _aliased():
    s = json.loads(json.dumps(SETTING))
    net = s["NeuralNetwork"]
    net["PolicyExtract"] = net.pop("PolicyHeadChannels")
    net["ValueExtract"] = net.pop("ValueHeadChannels")
    net["PolicyHeadType"] = "Normal"
    return s


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("setting", [SETTING, _aliased(), {
    "NeuralNetwork": {"ResidualChannels": 32, "PolicyHeadChannels": 8, "ValueHeadChannels": 8},
    "Train": {"TrainDirectory": "t", "StorePath": "s"}}], ids=["full", "v1_aliases", "defaults"])
def test_load_setting_matches_jax(tmp_path, setting):
    path = tmp_path / "setting.json"
    path.write_text(json.dumps(setting))
    for source in (str(path), json.dumps(setting)):
        want, got = JS.load_setting(source), TS.load_setting(source)
        wn = _fields(want.net)
        assert {k: wn[k] for k in _fields(got.net)} == _fields(got.net)
        assert _fields(got.train) == _fields(want.train)
        assert _fields(got.loop) == _fields(want.loop)
        assert got.json_str == want.json_str


def _broken():
    no_block = {"NeuralNetwork": SETTING["NeuralNetwork"]}
    bad_block = json.loads(json.dumps(SETTING))
    bad_block["NeuralNetwork"]["Stack"] = ["ResidualBlock", "ConvBlock"]
    no_channels = json.loads(json.dumps(SETTING))
    del no_channels["NeuralNetwork"]["ValueHeadChannels"]
    no_store = json.loads(json.dumps(SETTING))
    del no_store["Train"]["StorePath"]
    return [no_block, bad_block, no_channels, no_store]


@pytest.mark.parametrize("setting", _broken(),
                         ids=["no_train_block", "unknown_block", "no_head_channels", "no_store"])
def test_load_setting_errors_match_jax(setting):
    source = json.dumps(setting)
    with pytest.raises(ValueError) as want:
        JS.load_setting(source)
    with pytest.raises(ValueError) as got:
        TS.load_setting(source)
    assert str(got.value) == str(want.value)


def test_train_worker_stores_resumes_and_its_checkpoint_plays(chunks, tmp_path):
    out, _ = chunks
    setting = json.loads(json.dumps(SETTING))
    setting["NeuralNetwork"].update(MaxBoardSize=7, ResidualChannels=16, PolicyHeadChannels=8,
                                    ValueHeadChannels=8)
    setting["Train"].update(BatchSize=8, DownSampleRate=1, MaxStepsPerRunning=3, SwaSteps=2,
                            VerboseSteps=1, ValidationSteps=2, NumberChunks=None,
                            ChunksIncreasingC=None, TrainDirectory=str(out / "tdata"),
                            ValidationDirectory=str(out / "tdata"))
    (tmp_path / "setting.json").write_text(json.dumps(setting))
    argv = ["-j", str(tmp_path / "setting.json"), "-w", str(tmp_path), "--device", "cpu"]
    trainer = train_worker.main(argv)
    store = tmp_path / "store"
    name = "sayuri-tpu-b2xc16-s3-c2-w2"
    for f in (f"checkpoint/{name}.ckpt", f"weights/{name}.bin.txt", f"swa/{name}-swa.bin.txt"):
        assert (store / f).is_file(), f
    lines = (store / "training.log").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == ["step=1", "step=2", "step=3"]
    assert all(math.isfinite(float(kv.split("=")[1])) for ln in lines for kv in ln.split()[1:])
    assert (store / "validation.log").read_text().startswith("step=3 loss=")

    # the v5 file gives the trainer's eval-mode outputs
    _, net = load_checkpoint_for_inference(str(store / f"weights/{name}.bin.txt"))
    planes = torch.from_numpy(TD.wrap_sample(_samples(TD, chunks[1])[0].parse(), 7)[0][None])
    trainer.net.eval()
    with torch.no_grad():
        want, got = trainer.net(planes), net(planes)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)

    # a second run resumes at step 3
    assert train_worker.main(argv + ["--max-steps", "1"]).steps == 4
    assert (store / "training.log").read_text().splitlines()[-1].startswith("step=4 ")

    # the checkpoint reloads in the self-play pipe and plays GTP
    ckpt = str(store / f"checkpoint/{name}.ckpt")
    pipe = SelfPlayPipe(str(tmp_path / "sp"), boardsize=5, parallel_games=1,
                        weights_dir=str(store / "checkpoint"), device="cpu")
    assert pipe.current_weights.endswith("-s4-c2-w2.ckpt") and not pipe.should_reload()
    loop = CLI.build_gtp_loop(Options().parse_args(
        ["--mode", "gtp", "--weights", ckpt, "--boardsize", "5", "--playouts", "4"]),
        device="cpu")
    ok, move = loop.execute("genmove b")
    assert ok and move, move


def test_bench_train_reads_the_step_and_the_loader(chunks):
    """`bench train`'s readings at a tiny size on the CPU (the card's
    profiled window is skipped here): b6c96, batch 2, one step each; the
    thread switch interval is restored after."""
    import sys

    from sayuri_tpu_torch import bench

    out, _ = chunks
    switch = sys.getswitchinterval()
    res = bench.bench_train(chunks=out / "tdata", device="cpu", batch=2, warmup=1, steps=1)
    assert res["steps"] == 1 and res["batch"] == 2 and math.isfinite(res["loss"])
    assert res["step_samples_per_s"] > 0 and res["loader_alone_samples_per_s"] > 0
    for key in ("loader", "loader_fast_switch"):
        assert res[f"{key}_samples_per_s"] > 0 and 0.0 <= res[f"{key}_wait_share"] < 1.0
        assert 0.0 < res[f"{key}_train_ms"] <= res[f"{key}_step_ms"]
    assert res["chunk_boards"] == [5] and res["chunks"] == 2
    assert sys.getswitchinterval() == switch
