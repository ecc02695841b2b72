"""The port's net in training mode and its loss, against the JAX package on
the same seeded inputs and carried-over variables (7x7 buffer holding
5x5, 6x6 and 7x7 boards, so the batch norm's divisor is the on-board cell
count, not B * H * W):

- the train-mode forward (masked batch renorm) against
  ``net.apply(train=True, mutable=["batch_stats"])``: every head and the
  updated running statistics, at the default renorm and at rmax=2, dmax=1
  from random running statistics over two steps (r and d clip there);
- ``softplus_with_gradient_floor``: forward and the floored backward;
- the 11 loss parts and the gradient of the total loss for every parameter
  against ``jax.value_and_grad`` (the error head's gradient floor and the
  detach points included), with and without ``global_weight``.

Bounds: heads and loss parts within 1e-5 relative (heads: elementwise, plus
1e-5 absolute); statistics within 1e-5 absolute; each gradient within 1e-4
of its tensor's largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.models import network as JN
from sayuri_tpu.train import loss as JL
from sayuri_tpu_torch.models import network as TN
from sayuri_tpu_torch.models.network import SayuriNet
from sayuri_tpu_torch.train import loss as TL
from torch_train_util import (assert_parts_close, assert_tensors_close, batch,
                              net_configs, port_state, port_stats, to_numpy)

HEAD_TOL = 1e-5
STAT_TOL = 1e-5
GRAD_TOL = 1e-4


@functools.lru_cache
def _variables(jcfg, random_stats):
    """(JAX net, numpy variables) from one jitted init a config."""
    net = JN.SayuriNet(jcfg)
    dummy = jnp.zeros((2, jcfg.boardsize, jcfg.boardsize, 43)).at[..., -1].set(1.0)
    init = jax.jit(lambda key, x: net.init(key, x, train=False))
    variables = to_numpy(init(jax.random.PRNGKey(3), dummy))
    if random_stats:
        rng = np.random.RandomState(5)

        def draw(path, x):
            key = path[-1].key
            if key == "mean":
                return rng.normal(0, 0.5, x.shape).astype(np.float32)
            if key == "var":
                return rng.uniform(0.05, 4.0, x.shape).astype(np.float32)
            return x

        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            draw, variables["batch_stats"])
    return net, variables


def _heads(out):
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


@pytest.mark.parametrize("renorm", [False, True], ids=["default", "rmax2_dmax1"])
def test_train_forward_matches_jax(renorm):
    over = dict(renorm_max_r=2.0, renorm_max_d=1.0) if renorm else {}
    jcfg, tcfg = net_configs(**over)
    jnet, variables = _variables(jcfg, random_stats=renorm)
    tnet = SayuriNet(tcfg)
    tnet.load_state_dict(port_state(tcfg, variables))
    tnet.train()
    apply = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))
    params, stats = variables["params"], variables["batch_stats"]
    for step, seed in enumerate((0, 1) if renorm else (0,)):
        planes, _ = batch(seed)
        want, mutated = apply({"params": params, "batch_stats": stats}, jnp.asarray(planes))
        stats = to_numpy(mutated["batch_stats"])
        with torch.no_grad():
            got = tnet(torch.from_numpy(planes))
        for k, w in _heads(want).items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=HEAD_TOL, atol=HEAD_TOL,
                                       err_msg=f"step {step} head {k}")
        assert_tensors_close(dict(tnet.named_buffers()), port_stats(tcfg, params, stats),
                             STAT_TOL, f"step {step} statistics")
    if renorm:
        # r and d clip: the same statistics under plain batch norm differ
        plain = SayuriNet(net_configs()[1])
        plain.load_state_dict(port_state(tcfg, variables))
        with torch.no_grad():
            a = plain.train()(torch.from_numpy(batch(0)[0]))["prob"]
            tnet.load_state_dict(port_state(tcfg, variables))
            b = tnet(torch.from_numpy(batch(0)[0]))["prob"]
        assert (a - b).abs().max() > 1e-2


def test_softplus_gradient_floor_matches_jax():
    x = np.linspace(-8, 8, 97).astype(np.float32)
    g = np.random.RandomState(0).normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: JN.softplus_with_gradient_floor(v, 0.05, True), x)
    (want_grad,) = vjp(g)
    xt = torch.from_numpy(x).requires_grad_()
    got = TN.softplus_with_gradient_floor(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-6, atol=1e-7)
    # the floor: not the forward's derivative
    plain = torch.from_numpy(x).requires_grad_()
    torch.square(torch.nn.functional.softplus(0.5 * plain)).backward(torch.from_numpy(g))
    assert (plain.grad - xt.grad).abs().max() > 0.1


def test_eval_fn_refuses_a_training_mode_net():
    """Search evaluates in inference mode only: a net left in train() mode
    would renormalise each query batch and rewrite its statistics."""
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.models.evaluator import make_eval_fn

    net = SayuriNet(net_configs()[1])
    with pytest.raises(ValueError, match="eval"):
        make_eval_fn(GoEnv(n=7), net)
    make_eval_fn(GoEnv(n=7), net.eval())


@pytest.mark.parametrize("weighted", [True, False], ids=["global_weight", "no_weight"])
def test_loss_and_gradients_match_jax(weighted):
    jcfg, tcfg = net_configs()
    jnet, variables = _variables(jcfg, random_stats=False)
    planes, targets = batch(2)
    if not weighted:
        del targets["global_weight"]
    stats = variables["batch_stats"]

    def loss_fn(params, x, t):
        out, _ = jnet.apply({"params": params, "batch_stats": stats}, x, train=True,
                            mutable=["batch_stats"])
        return JL.compute_loss(out, t, x[..., -1:], 0.1)

    (_, want_parts), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jnp.asarray(planes), jax.tree.map(jnp.asarray, targets))
    assert len(want_parts) == 11

    tnet = SayuriNet(tcfg)
    tnet.load_state_dict(port_state(tcfg, variables))
    tnet.train()
    x = torch.from_numpy(planes)
    loss, parts = TL.compute_loss(tnet(x), {k: torch.from_numpy(v) for k, v in targets.items()},
                                  x[..., -1:], 0.1)
    loss.backward()
    assert_parts_close({k: v.item() for k, v in parts.items()}, want_parts, HEAD_TOL, "loss")
    want = port_state(tcfg, {"params": want_grads, "batch_stats": stats})
    got = {k: p.grad for k, p in tnet.named_parameters()}
    assert_tensors_close(got, {k: want[k] for k in got}, GRAD_TOL, "gradient", scale=True)
