"""The v5 weight file between the packages (models/weights_io.py):

- a file the JAX package exports (seeded weights with an SE block, BN
  statistics drawn from a numpy seed) loads into the port, whose float32
  forward is within 1e-5 of the JAX net's on the original variables;
- the port's export of the same weights is byte-identical to the JAX
  export (binary and text), so the JAX importer reads equal arrays;
- a JAX-package trainer checkpoint (.ckpt) whose msgpack is cut short is
  refused with a clear error,
  a port checkpoint written before NetConfig had ``policy_head_kernel``
  loads with its default, and the port's layer plan equals the JAX one
  entry for entry for a net of every block family with the RepLK head
  (test_torch_blocks.py holds those nets' files and outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.models import weights_io as JW
from sayuri_tpu.models.network import NetConfig as JNetConfig
from sayuri_tpu_torch.models import weights_io as TW
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from test_torch_network import STACK, random_planes, seeded_variables
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
N, C = 9, 16


@pytest.fixture(scope="module")
def weights():
    net, variables, tnet = seeded_variables(n=N, channels=C, seed=2)
    cfg = JNetConfig(boardsize=N, residual_channels=C, stack=STACK)
    return net, variables, tnet, cfg


@pytest.mark.parametrize("binary", [True, False])
def test_jax_export_loads_into_the_port(weights, tmp_path, binary):
    net, variables, _, cfg = weights
    path = str(tmp_path / "w.txt")
    JW.export_reference_weights(cfg, jax.device_get(variables), path, binary=binary)
    tcfg, tnet = TW.load_checkpoint_for_inference(path, boardsize=N)
    assert tuple(tcfg.stack) == STACK and tcfg.residual_channels == C
    planes = random_planes(b=3, n=N, seed=4)
    ref = net.apply(variables, jnp.asarray(planes), train=False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(planes))
    unscale = {"errors": np.array([0.25, 150.0], np.float32)}
    for k in ref:
        s = unscale.get(k, np.float32(1.0))
        np.testing.assert_allclose(got[k].numpy() / s, np.asarray(ref[k]) / s,
                                   atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("binary", [True, False])
def test_port_export_reads_back_in_jax(weights, tmp_path, binary):
    _, variables, tnet, cfg = weights
    jpath, tpath = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    JW.export_reference_weights(cfg, jax.device_get(variables), jpath, binary=binary)
    TW.export_reference_weights(tnet, tpath, binary=binary)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    jcfg, jvars = JW.import_reference_weights(tpath)
    wcfg, wvars = JW.import_reference_weights(jpath)
    assert jcfg == wcfg
    flat_a = jax.tree_util.tree_leaves_with_path(jvars)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(wvars))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(flat_b[path]), err_msg=str(path))


def test_port_roundtrip_gives_the_same_net(weights, tmp_path):
    _, _, tnet, _ = weights
    path = str(tmp_path / "w.txt")
    TW.export_reference_weights(tnet, path)
    _, back = TW.load_checkpoint_for_inference(path, boardsize=N)
    planes = torch.from_numpy(random_planes(b=2, n=N, seed=6))
    with torch.no_grad():
        a, b = tnet(planes), back(planes)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=ATOL, rtol=0, err_msg=k)


def test_refuses_checkpoints_and_unported_blocks(tmp_path):
    # a JAX-package trainer checkpoint (a pickle holding flax msgpack bytes)
    # whose msgpack is cut short is refused (a whole one is read:
    # test_torch_ckpt_jax.py; the port's own .ckpt: test_torch_train_pipeline.py)
    import pickle

    ckpt = tmp_path / "trainer.ckpt"
    ckpt.write_bytes(pickle.dumps({"state": b"\x85", "net_cfg": {}, "train_cfg": {},
                                   "extra": {}}))
    with pytest.raises(ValueError, match="trainer.ckpt: not a readable JAX-package trainer "
                                         "checkpoint"):
        TW.load_checkpoint_for_inference(str(ckpt))
    # no block family or policy head is left unported: the layer plans of a
    # net of every family agree, entry for entry, names mapped to flax scopes
    stack = ("ResidualBlock", "BottleneckBlock-SE", "NestedBottleneckBlock",
             "NestedBottleneckBlock-SE", "MixerBlock", "MixerBlockV1-SE", "MixerBlockV2",
             "BottleneckBlock", "ResidualBlock-SE")
    for head in ("Normal", "RepLK"):
        want = JW.layer_plan(JNetConfig(stack=stack, policy_head_type=head))
        got = TW.layer_plan(NetConfig(stack=stack, policy_head_type=head))
        assert [(k, "/".join(TW._flax_path(name))) for k, name in got] == want
    # both packages refuse the same unknown block
    for plan in (JW.layer_plan, TW.layer_plan):
        with pytest.raises(ValueError, match="unknown block ConvBlock"):
            plan(NetConfig(stack=("ConvBlock",)))


def test_checkpoint_without_policy_head_kernel_loads(tmp_path):
    """A .ckpt whose net_cfg predates ``policy_head_kernel`` loads with the
    field's default and the same net."""
    import dataclasses

    cfg = NetConfig(boardsize=N, residual_channels=C, stack=STACK)
    net = SayuriNet(cfg).init_random(5).eval()
    old_cfg = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "policy_head_kernel"}
    path = tmp_path / "old.ckpt"
    torch.save({"model": net.state_dict(), "net_cfg": old_cfg}, str(path))
    got_cfg, got = TW.load_checkpoint_for_inference(str(path))
    assert got_cfg == cfg and got_cfg.policy_head_kernel == 7
    planes = torch.from_numpy(random_planes(b=2, n=N, seed=7))
    with torch.no_grad():
        a, b = net(planes), got(planes)
    for k in a:
        assert torch.equal(a[k], b[k]), k
