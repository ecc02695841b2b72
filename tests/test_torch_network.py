"""The port's encoder, symmetry, network, weight conversion and evaluator
against the JAX package in float32 at a small size (2 blocks x 16
channels). Network outputs agree within 1e-5, the bound
tools/diff_raw_nn.py held the JAX net to; integer and plane outputs are
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sayuri_tpu.models import encoder as JE
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu.models import network as JN
from sayuri_tpu.models import symmetry as JS
from sayuri_tpu_torch.models import symmetry as TS
from sayuri_tpu_torch.models.encoder import encode
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.models.weights_io import from_flax_variables
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.game.state import GoEnv
from test_torch_board import jax_to_torch, random_jax_states

ATOL = 1e-5
STACK = ("ResidualBlock", "ResidualBlock-SE")


def seeded_variables(n=9, channels=16, seed=0):
    """flax variables whose kernels come from flax's seeded xavier init and
    whose biases, BN parameters and BN statistics are drawn from a numpy
    seed (init alone leaves BN at mean 0 / var 1, hiding the mapping)."""
    cfg = JN.NetConfig(boardsize=n, residual_channels=channels, stack=STACK)
    net = JN.SayuriNet(cfg)
    dummy = jnp.zeros((1, n, n, 43)).at[..., -1].set(1.0)
    variables = net.init(jax.random.PRNGKey(seed), dummy, train=False)
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        shape = np.shape(x)
        if "kernel" in name:
            return np.asarray(x, np.float32)
        if "var" in name:
            v = rng.uniform(0.5, 2.0, shape)
        elif "gamma" in name:
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return np.asarray(v, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))
    tnet = SayuriNet(NetConfig(boardsize=n, residual_channels=channels, stack=STACK))
    from_flax_variables(tnet, variables)
    return net, jax.tree.map(jnp.asarray, variables), tnet.eval()


def random_planes(b=3, n=9, seed=1):
    rng = np.random.RandomState(seed)
    planes = (rng.rand(b, n, n, 43) > 0.6).astype(np.float32)
    planes[..., 38:42] = rng.normal(size=(b, 1, 1, 4))
    sizes = [n, n - 2, n - 4][:b]
    mask = np.zeros((b, n, n), np.float32)
    for i, s in enumerate(sizes):
        mask[i, :s, :s] = 1.0
    planes *= mask[..., None]
    planes[..., 42] = mask
    return planes


def test_network_matches_flax_f32():
    net, variables, tnet = seeded_variables()
    planes = random_planes()
    ref = net.apply(variables, jnp.asarray(planes), train=False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(planes))
    assert set(ref) == set(got)
    # `errors` carries fixed output scales (x0.25, x150): compare the head's
    # own output, before that scale, like every other output
    unscale = {"errors": np.array([0.25, 150.0], np.float32)}
    for k in ref:
        s = unscale.get(k, np.float32(1.0))
        np.testing.assert_allclose(np.asarray(ref[k]) / s, got[k].numpy() / s,
                                   atol=ATOL, rtol=0, err_msg=k)


def test_symmetry_transforms_and_draw_match():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(8, 9, 9, 5)).astype(np.float32)
    p = rng.normal(size=(8, 82)).astype(np.float32)
    syms = np.arange(8, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(JS.transform_planes_batch(jnp.asarray(x), jnp.asarray(syms))),
        TS.transform_planes_batch(torch.from_numpy(x), torch.from_numpy(syms)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(JS.inverse_transform_policy_batch(
            jnp.asarray(p), jnp.asarray(syms), 9)),
        TS.inverse_transform_policy_batch(
            torch.from_numpy(p), torch.from_numpy(syms), 9).numpy(),
    )
    for s in range(8):
        np.testing.assert_array_equal(
            np.asarray(JS.transform_planes(jnp.asarray(x), s)),
            TS.transform_planes(torch.from_numpy(x), s).numpy(),
        )
    _, js, _ = random_jax_states(n=9, b=16, moves=9, seed=5)
    ts = jax_to_torch(js)
    for seed in (0, 1, 12345):
        np.testing.assert_array_equal(
            np.asarray(JS.random_symmetries(js, seed)),
            TS.random_symmetries(ts, seed).numpy(),
        )


def test_encoder_matches_jax_all_planes():
    env, js, _ = random_jax_states(n=9, b=4, moves=30, seed=6)
    js = js.replace(komi=jnp.asarray([7.5, 6.5, 0.5, 5.0], jnp.float32),
                    rule=jnp.asarray([0, 1, 0, 0], jnp.int32))
    ts = jax_to_torch(js)
    ladders = np.random.RandomState(0).rand(4, 9, 9, 4) > 0.8
    ref = jax.vmap(lambda s, l: JE.encode(env, s, ladder_planes=l))(
        js, jnp.asarray(ladders))
    ana = TA.board_analysis(ts.stones, ts.size, ts.ko, ts.to_move)
    got = encode(GoEnv(n=9), ts, torch.from_numpy(ladders), ana["libs"],
                 ana["safe"], ana["score_ownership"])
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_evaluator_matches_jax_random_symmetry():
    net, variables, tnet = seeded_variables()
    env, js, _ = random_jax_states(n=9, b=4, moves=25, seed=8)
    ts = jax_to_torch(js)
    jfn = JEV.make_eval_fn(env, net, variables, symmetry="random",
                           ladder_mode="off")
    tfn = make_eval_fn(GoEnv(n=9), tnet, symmetry="random", ladder_mode="off")
    ref = jax.jit(jfn)(js)
    got = tfn(ts)
    for k in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(ref, k)),
                                   getattr(got, k).numpy(), atol=ATOL, rtol=0,
                                   err_msg=k)
