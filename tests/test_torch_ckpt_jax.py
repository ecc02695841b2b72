"""Reading a JAX-package trainer checkpoint (models/weights_io.py): a tiny
7x7 net's TrainState written by the JAX ``Trainer.save_checkpoint`` (with
seeded batch-norm statistics) is read by the port's
``load_checkpoint_for_inference`` in a process where jax and flax cannot
be imported, and its heads equal the JAX net's on the same planes within
1e-5, absolute and relative (f32; the value heads reach ~1e2). A pickle
that holds another class is refused."""

import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sayuri_tpu.models import network as JN
from sayuri_tpu.train.pipeline import Trainer as JTrainer, TrainConfig as JTrainConfig
from sayuri_tpu.train.pipeline import TrainState as JTrainState
from sayuri_tpu_torch.models import weights_io as TW
from torch_train_util import N, batch, net_configs

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5

# the port reads the checkpoint and runs its net where jax / flax / the
# JAX package cannot be imported
READ = """
import sys
for m in ('jax', 'jaxlib', 'flax', 'sayuri_tpu'):
    sys.modules[m] = None
import numpy as np, torch
from sayuri_tpu_torch.models.weights_io import load_checkpoint_for_inference
cfg, net = load_checkpoint_for_inference(sys.argv[1])
planes = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    out = net(planes)
np.savez(sys.argv[3], boardsize=cfg.boardsize, **{k: v.numpy() for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(path, JAX net, variables): a TrainState of the tiny net saved
    through Trainer.save_checkpoint (its optimizer state from the
    Trainer's own optimizer)."""
    jcfg, _ = net_configs()
    net = JN.SayuriNet(jcfg)
    dummy = jnp.zeros((2, N, N, 43)).at[..., -1].set(1.0)
    v = jax.jit(lambda k, x: net.init(k, x, train=False))(jax.random.PRNGKey(3), dummy)
    rng = np.random.RandomState(5)

    def draw(path, x):
        key = path[-1].key
        if key == "mean":
            return jnp.asarray(rng.normal(0, 0.5, x.shape), jnp.float32)
        if key == "var":
            return jnp.asarray(rng.uniform(0.05, 4.0, x.shape), jnp.float32)
        return x

    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map_with_path(draw, v["batch_stats"])}
    trainer = SimpleNamespace(net_cfg=jcfg, cfg=JTrainConfig(batch_size=8))
    tx = JTrainer._make_optimizer(trainer)
    trainer.state = JTrainState(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        swa_params=jax.tree.map(jnp.copy, v["params"]), swa_count=jnp.zeros((), jnp.int32),
        steps=jnp.asarray(7, jnp.int32), samples=jnp.asarray(56, jnp.int32))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.ckpt"
    JTrainer.save_checkpoint(trainer, str(path), extra={"setting_json": "{}"})
    return path, net, v


def test_jax_checkpoint_loads_without_flax(checkpoint, tmp_path):
    path, net, variables = checkpoint
    planes, _ = batch(seed=2)
    np.save(tmp_path / "planes.npy", planes)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", READ, str(path), str(tmp_path / "planes.npy"),
                          str(tmp_path / "out.npz")], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    got = np.load(tmp_path / "out.npz")
    want = jax.jit(lambda p: net.apply(variables, p, train=False))(jnp.asarray(planes))
    assert int(got["boardsize"]) == N
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=TOL, rtol=TOL, err_msg=k)


def test_jax_checkpoint_config_and_refusal(checkpoint, tmp_path):
    path, _, variables = checkpoint
    net_cfg, got = TW.read_jax_checkpoint(path)
    _, tcfg = net_configs()
    assert net_cfg == {**tcfg.__dict__}
    for part in ("params", "batch_stats"):
        jax.tree.map(np.testing.assert_array_equal, got[part],
                     jax.tree.map(np.asarray, variables[part]))
    cfg, net = TW.load_checkpoint_for_inference(path, boardsize=5)
    assert cfg.boardsize == 5 and not net.training
    bad = tmp_path / "other.ckpt"
    bad.write_bytes(pickle.dumps({"state": SimpleNamespace()}))
    with pytest.raises(ValueError, match="not a JAX-package trainer checkpoint"):
        TW.load_checkpoint_for_inference(bad)
