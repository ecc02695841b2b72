"""The port's Trainer against the JAX package's Trainer, from the same
initial parameters and statistics (carried through from_flax_variables; SWA
starts as the same copy and both optimizer states at zero), on the same
seeded batches (7x7 buffer holding 5x5-7x7 boards, batch 8):

- three steps each of SGD with warmup, Adam, macro_factor=2 (the
  parameters unchanged after the first micro-batch), a binding grad_clip,
  and SWA with swa_steps=2 over five steps: the loss parts of every step,
  then the parameters, statistics, SWA parameters and counters;
- a non-finite loss raises FloatingPointError;
- a checkpoint round trip restores every tensor and counter, and a resumed
  trainer's next step equals an uninterrupted one's;
- the port's loader reads the JAX package's checkpoint (its net equal to
  the JAX trainer's variables carried across) and its own.

Bounds: loss parts within 1e-5 relative; parameters, statistics and SWA
within 1e-5 absolute. One exception, under Adam only: the input conv's
centre tap on the mask plane. The mask is 1 on every on-board cell, so that
weight adds a per-channel constant which the batch norm's mean removes: its
gradient is zero in exact arithmetic and rounding noise (about 1e-8) in
both packages, and Adam scales noise to a step of up to lr either way. It is
held to the bound that follows from that, |change| <= lr a step, in both.
"""

import math

import numpy as np
import pytest
import torch

from sayuri_tpu.train.pipeline import TrainConfig as JTrainConfig
from sayuri_tpu.train.pipeline import Trainer as JTrainer
from sayuri_tpu_torch.models.weights_io import load_checkpoint_for_inference
from sayuri_tpu_torch.train import pipeline as TP
from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer
from torch_train_util import (assert_parts_close, assert_tensors_close, batch, net_configs,
                              port_params, port_state, port_stats, to_numpy)
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

# the module's CPU work on one torch thread: the suite runs several workers
# on the same cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

PART_TOL = 1e-5
STATE_TOL = 1e-5

CASES = {
    "sgd_warmup": dict(lr_schedule=((0, 0.02), (2, 0.01)), warmup_steps=4),
    "adam": dict(optimizer="Adam", lr_schedule=((0, 1e-3),)),
    "macro2": dict(macro_factor=2, lr_schedule=((0, 0.02),), warmup_steps=3),
    "clip": dict(grad_clip=0.5, lr_schedule=((0, 0.02),)),
    "swa": dict(swa_steps=2, swa_max_count=3, lr_schedule=((0, 0.02),)),
}
STEPS = {"swa": 5}


@pytest.fixture(scope="module")
def configs():
    return net_configs()


def _pair(configs, over):
    jcfg, tcfg = configs
    jt = JTrainer(jcfg, JTrainConfig(batch_size=8, **over))
    init = {"params": jt.unreplicated_params(), "batch_stats": jt.unreplicated_batch_stats()}
    tt = Trainer(tcfg, TrainConfig(batch_size=8, **over), device="cpu",
                 init_state=port_state(tcfg, init))
    return jt, tt, init


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax(configs, case):
    tcfg = configs[1]
    jt, tt, init = _pair(configs, CASES[case])
    start = {k: p.detach().clone() for k, p in tt.net.named_parameters()}
    for step in range(STEPS.get(case, 3)):
        planes, targets = batch(10 + step)
        want = jt.train_batch(planes, targets)
        got = tt.train_batch(planes, targets)
        assert_parts_close(got, want, PART_TOL, f"{case} step {step}")
        if case == "macro2" and step == 0:
            # the first micro-batch moves no parameter
            for k, p in tt.net.named_parameters():
                assert torch.equal(p, start[k]), k
            assert tt.updates == 0 and tt.steps == 1
    s = jt.state
    assert (tt.steps, tt.samples, tt.swa_count) == (int(s.steps), int(s.samples),
                                                   int(s.swa_count))
    params, stats = to_numpy(s.params), to_numpy(s.batch_stats)
    got, want = tt.unreplicated_params(), port_params(tcfg, params, stats)
    if case == "adam":
        key, tap = "input_conv.conv.weight", (slice(None), 42, 1, 1)
        first = port_params(tcfg, init["params"], init["batch_stats"])[key][tap]
        lr, steps = CASES[case]["lr_schedule"][0][1], STEPS.get(case, 3)
        for w in (got[key][tap], want[key][tap]):
            assert float((w - first).abs().max()) <= steps * lr * 1.001
        got[key][tap] = want[key][tap] = 0.0
    assert_tensors_close(got, want, STATE_TOL, f"{case} parameters")
    assert_tensors_close(tt.unreplicated_batch_stats(), port_stats(tcfg, params, stats),
                         STATE_TOL, f"{case} statistics")
    assert_tensors_close(tt.unreplicated_swa_params(),
                         port_params(tcfg, to_numpy(s.swa_params), stats),
                         STATE_TOL, f"{case} SWA")
    if case == "swa":
        assert tt.swa_count == 2
    if case == "clip":
        # the clip binds: the raw gradient's global norm is above it
        planes, targets = batch(99)
        out = tt.net(torch.from_numpy(planes))
        loss, _ = TP.compute_loss(out, {k: torch.from_numpy(v) for k, v in targets.items()},
                                  torch.from_numpy(planes[..., -1:]))
        grads = torch.autograd.grad(loss, tt.params)
        assert math.sqrt(sum(float(g.square().sum()) for g in grads)) > 0.5


def test_lr_counts_updates_not_micro_batches():
    cfg = TrainConfig(lr_schedule=((0, 0.1), (3, 0.01)), warmup_steps=4, macro_factor=2)
    assert [TP.lr_at(cfg, u) for u in range(5)] == pytest.approx(
        [0.025, 0.05, 0.075, 0.01, 0.01])
    jt = JTrainConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    from sayuri_tpu.train.pipeline import lr_at as jlr_at

    for u in range(6):
        assert TP.lr_at(cfg, u) == pytest.approx(float(jlr_at(jt, u)), rel=1e-6)


def test_clip_scales_by_max_over_norm_without_epsilon(configs):
    """Gradients of global norm 4e-6 under grad_clip 1e-6 (an epsilon of
    1e-6 in the divisor would shrink them 20%): one SGD update equals the
    optax chain's on the same gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    over = dict(lr_schedule=((0, 1.0),), weight_decay=0.0, grad_clip=1e-6)
    tt = Trainer(configs[1], TrainConfig(**over), device="cpu")
    rng = np.random.RandomState(0)
    grads = [rng.normal(size=p.shape).astype(np.float32) for p in tt.params]
    scale = 4e-6 / math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [(g * scale).astype(np.float32) for g in grads]
    with torch.no_grad():
        for p in tt.params:      # so that each parameter after the update is the update
            p.zero_()
        tt._update([torch.from_numpy(g) for g in grads])
    tx = optax.chain(optax.clip_by_global_norm(1e-6), optax.add_decayed_weights(0.0),
                     optax.sgd(1.0, momentum=0.9, nesterov=True))
    jg = [jnp.asarray(g) for g in grads]
    want, _ = jax.jit(tx.update)(jg, tx.init(jg), jg)
    for p, w in zip(tt.params, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-14)


def test_non_finite_loss_raises(configs):
    tt = Trainer(configs[1], TrainConfig(batch_size=8), device="cpu")
    planes, targets = batch(3)
    targets["q_vals"][0, 0] = np.nan
    with pytest.raises(FloatingPointError, match="step 1"):
        tt.train_batch(planes, targets)


@pytest.mark.parametrize("over", [dict(optimizer="Adam", swa_steps=2),
                                  dict(macro_factor=2, warmup_steps=5, swa_steps=1)],
                         ids=["adam", "sgd_macro2"])
def test_checkpoint_round_trip_and_resume(configs, tmp_path, over):
    cfg = TrainConfig(batch_size=8, **over)
    a = Trainer(configs[1], cfg, device="cpu", seed=1)
    for i in range(3):
        a.train_batch(*batch(20 + i))
    path = str(tmp_path / (a.checkpoint_name(num_chunks=4, window=3) + ".ckpt"))
    assert path.endswith("sayuri-tpu-b2xc16-s3-c4-w3.ckpt")
    a.save_checkpoint(path, extra={"run": 7})
    assert Trainer.latest_checkpoint(str(tmp_path)) == path
    b = Trainer(configs[1], cfg, device="cpu", seed=2)
    assert b.load_checkpoint(path) == {"run": 7}
    for k in ("steps", "samples", "updates", "swa_count", "mini_step"):
        assert getattr(b, k) == getattr(a, k), k
    for get in ("unreplicated_params", "unreplicated_swa_params", "unreplicated_batch_stats"):
        assert_tensors_close(getattr(b, get)(), getattr(a, get)(), 0.0, get)
    assert_tensors_close(b.opt.state_dict()["state"][0], a.opt.state_dict()["state"][0],
                         0.0, "optimizer state")
    planes, targets = batch(30)
    assert b.train_batch(planes, targets) == a.train_batch(planes, targets)
    assert_tensors_close(b.unreplicated_params(), a.unreplicated_params(), 0.0, "resumed")


def test_inference_loader_reads_port_ckpt_and_refuses_jax_ckpt(configs, tmp_path):
    jcfg, tcfg = configs
    jt = JTrainer(jcfg, JTrainConfig(batch_size=8))
    jax_ckpt = str(tmp_path / "jax.ckpt")
    jt.save_checkpoint(jax_ckpt)
    jcfg_read, jnet = load_checkpoint_for_inference(jax_ckpt)
    assert jcfg_read.stack == tcfg.stack and not jnet.training
    want = port_state(tcfg, {"params": jt.unreplicated_params(),
                             "batch_stats": jt.unreplicated_batch_stats()})
    for k, v in jnet.state_dict().items():
        assert torch.equal(v, want[k]), k

    tt = Trainer(tcfg, TrainConfig(batch_size=8), device="cpu")
    tt.train_batch(*batch(4))
    path = str(tmp_path / "port.ckpt")
    tt.save_checkpoint(path)
    cfg, net = load_checkpoint_for_inference(path, boardsize=9)
    assert cfg.boardsize == 9 and not net.training
    assert cfg.stack == tcfg.stack
    planes = torch.from_numpy(batch(5)[0])
    tt.net.eval()
    with torch.no_grad():
        want, got = tt.net(planes), net(planes)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the net, not the SWA average (which one step moved apart)
    swa = tt.unreplicated_swa_params()
    assert any(not torch.equal(swa[k], p) for k, p in net.named_parameters())
