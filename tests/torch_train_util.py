"""Shared by the test_torch_train_* files: the tiny net both packages
train, seeded batches of small games in a larger buffer, and the carry of
JAX variables (or gradients) into the port's state dict."""

import jax
import numpy as np
import torch

from sayuri_tpu.models.network import NetConfig as JNetConfig
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.models.weights_io import from_flax_variables

N = 7                                   # the buffer
SIZES = (5, 5, 5, 5, 5, 5, 6, 7)        # board sizes of a batch of 8
NET = dict(boardsize=N, residual_channels=16, stack=("ResidualBlock", "ResidualBlock-SE"),
           policy_head_channels=8, value_head_channels=8)


def net_configs(**over):
    """(JAX NetConfig, port NetConfig) of the tiny net."""
    kw = {**NET, **over}
    return JNetConfig(**kw), NetConfig(**kw)


def batch(seed, sizes=SIZES, n=N):
    """Planes [B, n, n, 43] of boards of `sizes` in the n x n buffer and the
    targets of a training batch, zero off the board, as wrap_sample lays
    them out."""
    rng = np.random.RandomState(seed)
    b, hw = len(sizes), n * n
    mask = np.zeros((b, n, n), np.float32)
    for i, s in enumerate(sizes):
        mask[i, :s, :s] = 1.0
    planes = (rng.rand(b, n, n, 43) > 0.6).astype(np.float32)
    planes[..., 37:42] = rng.normal(size=(b, 1, 1, 5))
    planes *= mask[..., None]
    planes[..., 42] = mask
    pmask = np.concatenate([mask.reshape(b, hw), np.ones((b, 1), np.float32)], 1)

    def policy():
        p = rng.rand(b, hw + 1).astype(np.float32) ** 4 * pmask
        return p / p.sum(-1, keepdims=True)

    wdl = np.zeros((b, 3), np.float32)
    wdl[np.arange(b), rng.randint(0, 3, b)] = 1.0
    targets = {
        "prob": policy(),
        "aux_prob": policy(),
        "ownership": (rng.choice([-1.0, 0.0, 1.0], (b, n, n)) * mask).reshape(b, hw)
        .astype(np.float32),
        "wdl": wdl,
        "q_vals": rng.uniform(-1, 1, (b, 5)).astype(np.float32),
        "scores": rng.normal(0, 8, (b, 5)).astype(np.float32),
        "global_weight": rng.uniform(0.5, 1.5, b).astype(np.float32),
    }
    return planes, targets


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


def port_state(cfg, variables):
    """The port's state dict of a JAX {'params', 'batch_stats'} tree."""
    return from_flax_variables(SayuriNet(cfg), to_numpy(variables)).state_dict()


def port_params(cfg, params, stats):
    """JAX params-shaped tree (parameters or gradients) -> {name: tensor}
    keyed like the port's named_parameters()."""
    sd = port_state(cfg, {"params": params, "batch_stats": stats})
    names = {k for k, _ in SayuriNet(cfg).named_parameters()}
    return {k: v for k, v in sd.items() if k in names}


def port_stats(cfg, params, stats):
    sd = port_state(cfg, {"params": params, "batch_stats": stats})
    names = {k for k, _ in SayuriNet(cfg).named_buffers()}
    return {k: v for k, v in sd.items() if k in names}


def assert_tensors_close(got, want, atol, tag, scale=False):
    """Every tensor of `got` (dict of tensors) within `atol` of `want`'s
    (dict of arrays or tensors), absolute or, with `scale`, relative to the
    largest magnitude of each tensor of `want`."""
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(torch.as_tensor(got[k]).detach(), np.float64)
        bound = atol * (max(np.abs(w).max(), 1e-30) if scale else 1.0)
        err = np.abs(g - w).max()
        assert err <= bound, f"{tag} {k}: max abs err {err:.3g} > {bound:.3g}"


def assert_parts_close(got, want, rtol, tag):
    """Loss parts (floats) within `rtol` relative."""
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for k in want:
        w, g = float(want[k]), float(got[k])
        assert abs(g - w) <= rtol * max(abs(w), 1e-6), f"{tag} {k}: {g} vs {w}"
