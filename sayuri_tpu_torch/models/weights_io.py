"""Weight conversion into the PyTorch network.

``from_flax_variables`` loads a JAX-package ``{'params', 'batch_stats'}``
tree (numpy arrays; no JAX needed) into a ``SayuriNet``: conv kernels go
from HWIO to OIHW, dense kernels from [in, out] to [out, in], and each
masked batch norm's beta/gamma/mean/var map onto the port's module.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from sayuri_tpu_torch.models.network import ConvBlock, Dense, SayuriNet


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _flax_path(name: str):
    """Dotted torch module name -> flax scope path ('tower.3.conv1' ->
    ['tower3', 'conv1'])."""
    parts = name.split(".")
    out = []
    for p in parts:
        if p.isdigit() and out and out[-1] == "tower":
            out[-1] = f"tower{p}"
        else:
            out.append(p)
    return out


def from_flax_variables(net: SayuriNet, variables) -> SayuriNet:
    """Copy a flax variables tree into `net` (in place) and return it."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())

    for name, mod in net.named_modules():
        if not name:
            continue
        path = _flax_path(name)
        if isinstance(mod, ConvBlock):
            p = _node(params, path)
            s = _node(stats, path)["MaskedBatchNorm_0"]
            sd[f"{name}.conv.weight"] = t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1)
            bn = p["MaskedBatchNorm_0"]
            sd[f"{name}.bn.beta"] = t(bn["beta"])
            if mod.bn.gamma is not None:
                sd[f"{name}.bn.gamma"] = t(bn["gamma"])
            sd[f"{name}.bn.mean"] = t(s["mean"])
            sd[f"{name}.bn.var"] = t(s["var"])
        elif isinstance(mod, Dense):
            p = _node(params, path)["Dense_0"]
            sd[f"{name}.fc.weight"] = t(p["kernel"]).T
            sd[f"{name}.fc.bias"] = t(p["bias"])
        elif isinstance(mod, nn.Conv2d) and "." not in name:
            p = _node(params, path)
            sd[f"{name}.weight"] = t(p["kernel"]).permute(3, 2, 0, 1)
            sd[f"{name}.bias"] = t(p["bias"])
    # strict: every parameter and statistic of the port must be covered
    net.load_state_dict({k: v.contiguous() for k, v in sd.items()}, strict=True)
    return net
