"""Weight conversion into the PyTorch network, and the reference engine's
v5 weight file.

``from_flax_variables`` loads a JAX-package ``{'params', 'batch_stats'}``
tree (numpy arrays; no JAX needed) into a ``SayuriNet``: conv kernels go
from HWIO to OIHW, dense kernels from [in, out] to [out, in], and each
masked batch norm's beta/gamma/mean/var map onto the port's module.

The v5 text file (``get main { get info / get stack / get struct / get
parameters }``) is what the trainer and the engine exchange:

- ``export_reference_weights(net, filename)`` writes the port's net;
- ``import_reference_weights(filename)`` parses a file into
  (NetConfig, state dict); ``finalize_imported_variables`` builds the net;
- ``load_checkpoint_for_inference(path)`` does both for a v5 file, and
  reads the net of a trainer checkpoint (``.ckpt``): the port's own
  (``torch.save``), or the JAX package's (``read_jax_checkpoint``).

The layers are linearized in the reference collector's order
(``layer_plan``: input conv, tower sublayers, policy head, value head).
Batch norms are stored merged ((x - mean) / std with gamma and beta folded
in); on import they land in the running statistics with identity gamma and
zero beta, which gives the same inference. A depthwise conv block (the
mixer's, the RepLK head's) is stored as one merged kernel and bias: each
conv's effective kernel (its gamma broadcast folded in), the 3x3 one
zero-padded into the k x k one; on import the merged kernel lands in
``conv`` with gamma 0, and ``rep3x3`` is zero. Every block family and both
policy heads of the net are read and written.

The JAX package's trainer checkpoint is a pickle of builtins whose
``state`` is flax's msgpack encoding of the TrainState: an ndarray is a
msgpack ext of type 1 holding the msgpack of (shape, dtype name, bytes), a
numpy scalar one of type 3. ``read_jax_checkpoint`` decodes it with
``msgpack`` and an ext hook (no flax, no JAX) and hands the params and
batch statistics to ``from_flax_variables``.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.nn as nn

from sayuri_tpu_torch.models.network import (ConvBlock, Dense, DepthwiseConvBlock, NetConfig,
                                             SayuriNet)


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
        if isinstance(mod, (ConvBlock, DepthwiseConvBlock)):
            p = _node(params, path)
            s = _node(stats, path)["MaskedBatchNorm_0"]
            if isinstance(mod, ConvBlock):
                sd[f"{name}.conv.weight"] = t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1)
            else:
                for sub in ("conv", "rep3x3"):
                    q = p[sub]                      # weight [k, k, C] -> [C, 1, k, k]
                    sd[f"{name}.{sub}.weight"] = t(q["weight"]).permute(2, 0, 1)[:, None]
                    sd[f"{name}.{sub}.gamma"] = t(q["gamma"])
                    sd[f"{name}.{sub}.bias"] = t(q["bias"])
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


# ---------------------------------------------------------------------------
# the v5 weight file
# ---------------------------------------------------------------------------

_EPS = 1e-5
_BIN_SENTINEL = b"\xff\xff\xff\xff"


def _block_layers(spec: str, prefix: str):
    """(kind, module name) entries of one tower block in collector order,
    kind in {conv_block, dw_block, fc}."""
    parts = spec.split("-")
    kind = [p for p in parts if p != "SE"][0]
    if kind == "ResidualBlock":
        subs = ["conv1", "conv2"]
    elif kind == "BottleneckBlock":
        subs = ["pre", "conv1", "conv2", "post"]
    elif kind == "NestedBottleneckBlock":
        subs = ["pre", "block1.conv1", "block1.conv2", "block2.conv1", "block2.conv2", "post"]
    elif kind.startswith("MixerBlock"):
        subs = ["dw", "ffn1", "ffn2"]
    else:
        raise ValueError(f"unknown block {spec}")
    out = [("dw_block" if s == "dw" else "conv_block", f"{prefix}.{s}") for s in subs]
    if "SE" in parts:
        out += [("fc", f"{prefix}.se.squeeze"), ("fc", f"{prefix}.se.excite")]
    return out


def layer_plan(cfg: NetConfig):
    """Collector-order layer list [(kind, module name)], kind in
    {conv_block, dw_block, fc, conv}: input conv, tower sublayers, policy
    head, value head."""
    plan = [("conv_block", "input_conv")]
    for i, spec in enumerate(cfg.stack):
        plan += _block_layers(spec, f"tower.{i}")
    plan += [("conv_block", "policy_conv")]
    if cfg.policy_head_type == "RepLK":
        plan += [("dw_block", "policy_dw"), ("conv_block", "policy_pw")]
    plan += [
        ("fc", "policy_inter"),
        ("conv", "pol_misc"),
        ("fc", "pol_pass"),
        ("conv_block", "value_conv"),
        ("fc", "value_inter"),
        ("conv", "ownership_conv"),
        ("fc", "value_misc"),
    ]
    return plan


def _np(t):
    return t.detach().float().cpu().numpy()


def _merged_bn(bn):
    """(mean, std) of a batch norm with its gamma and beta folded in."""
    mean = _np(bn.mean)
    std = np.sqrt(_EPS + _np(bn.var))
    if bn.gamma is not None:
        std = std / _np(bn.gamma)
    return mean - _np(bn.beta) * std, std


def _dw_merged(mod):
    """Merged kernel [C, 1, k, k] and bias [C] of a DepthwiseConvBlock, in
    numpy and in the JAX exporter's order of operations (its weights in
    [k, k, C]), so that both packages write the same bytes."""

    def eff(conv):
        w = np.ascontiguousarray(_np(conv.weight)[:, 0].transpose(1, 2, 0))   # [k, k, C]
        g = _np(conv.gamma)
        w_eff = w + np.sum(w * g[None, None, :], axis=-1, keepdims=True)
        return np.transpose(w_eff, (2, 0, 1))[:, None]

    wk, w3 = eff(mod.conv), eff(mod.rep3x3)
    ps = (wk.shape[-1] - 3) // 2
    w3p = np.pad(w3, ((0, 0), (0, 0), (ps, ps), (ps, ps)))
    return wk + w3p, _np(mod.conv.bias) + _np(mod.rep3x3.bias)


def _emit(kind, mod):
    """(struct lines, flat float32 tensors in file order) of one layer."""
    if kind == "conv_block":
        w = _np(mod.conv.weight)
        oc, ic, ks = w.shape[0], w.shape[1], w.shape[2]
        mean, std = _merged_bn(mod.bn)
        return (f"Convolution {ic} {oc} {ks}\nBatchNorm {oc}\n",
                [w.ravel(), np.zeros(oc, np.float32), mean, std])
    if kind == "dw_block":
        w, bias = _dw_merged(mod)
        c, ks = w.shape[0], w.shape[-1]
        mean, std = _merged_bn(mod.bn)
        return (f"DepthwiseConvolution 1 {c} {ks}\nBatchNorm {c}\n",
                [w.ravel(), bias, mean, std])
    if kind == "conv":
        w = _np(mod.weight)
        return (f"Convolution {w.shape[1]} {w.shape[0]} {w.shape[2]}\n",
                [w.ravel(), _np(mod.bias)])
    w = _np(mod.fc.weight)                                # [out, in]
    return f"FullyConnect {w.shape[1]} {w.shape[0]}\n", [w.ravel(), _np(mod.fc.bias)]


def export_reference_weights(net: SayuriNet, filename: str, binary: bool = True):
    """Write `net` as a v5 engine weight file."""
    cfg = net.cfg
    plan = layer_plan(cfg)
    mods = dict(net.named_modules())
    layers = [_emit(kind, mods[name]) for kind, name in plan]
    info = [
        "NNType Network", "Version 5",
        f"FloatType {'float32bin' if binary else 'float32'}",
        f"InputChannels {cfg.input_channels}",
        f"ResidualChannels {cfg.residual_channels}",
        f"ResidualBlocks {len(cfg.stack)}",
        f"PolicyHeadChannels {cfg.policy_head_channels}",
        f"ValueHeadChannels {cfg.value_head_channels}",
        f"ValueMisc {cfg.value_misc}",
        f"PolicyHeadType {cfg.policy_head_type}",
        f"ActivationFunction {cfg.activation}",
    ]
    with open(filename, "wb") as f:
        w = lambda s: f.write(s.encode())                 # noqa: E731
        w("get main\nget info\n" + "".join(x + "\n" for x in info) + "end info\n")
        w("get stack\n" + "".join(s + "\n" for s in cfg.stack) + "end stack\n")
        w("get struct\n" + "".join(lines for lines, _ in layers) + "end struct\n")
        w("get parameters\n")
        for _, arrays in layers:
            for arr in arrays:
                arr = np.asarray(arr, np.float32).ravel()
                if binary:
                    f.write(arr.astype("<f4").tobytes() + _BIN_SENTINEL)
                else:
                    w(" ".join(repr(float(x)) for x in arr) + "\n")
        w("end parameters\nend main")


def import_reference_weights(filename: str):
    """Parse a v5 weight file into (NetConfig, state dict of the port's
    SayuriNet, without the gamma of batch norms that have none in the file:
    ``finalize_imported_variables`` adds them)."""
    with open(filename, "rb") as f:
        blob = f.read()

    def read_line(pos):
        end = blob.index(b"\n", pos)
        return blob[pos:end].decode().strip(), end + 1

    def section(pos, stop):
        out = []
        while True:
            line, pos = read_line(pos)
            if line == stop:
                return out, pos
            out.append(line)

    line, pos = read_line(0)
    if line != "get main":
        raise ValueError(f"{filename}: not a v5 weight file (first line {line!r})")
    info, stack, structs = {}, [], []
    while True:
        tok, pos = read_line(pos)
        if tok == "get info":
            lines, pos = section(pos, "end info")
            info = dict(x.split(None, 1) for x in lines)
        elif tok == "get stack":
            stack, pos = section(pos, "end stack")
        elif tok == "get struct":
            lines, pos = section(pos, "end struct")
            structs = [x.split() for x in lines]
        elif tok in ("get parameters", "end main"):
            break
    binary = info.get("FloatType", "float32") == "float32bin"
    cfg = NetConfig(
        input_channels=int(info.get("InputChannels", 43)),
        residual_channels=int(info.get("ResidualChannels", 96)),
        stack=tuple(stack),
        policy_head_channels=int(info.get("PolicyHeadChannels", 32)),
        value_head_channels=int(info.get("ValueHeadChannels", 32)),
        policy_head_type=info.get("PolicyHeadType", "Normal"),
        activation=info.get("ActivationFunction", "relu"),
    )

    def read_tensor(n, pos):
        if binary:
            arr = np.frombuffer(blob, "<f4", count=n, offset=pos)
            pos += 4 * n
            if blob[pos:pos + 4] != _BIN_SENTINEL:
                raise ValueError(f"{filename}: bad tensor sentinel at byte {pos}")
            return np.array(arr), pos + 4
        end = blob.index(b"\n", pos)
        arr = np.array([float(x) for x in blob[pos:end].split()], np.float32)
        if arr.size != n:
            raise ValueError(f"{filename}: tensor of {arr.size} values, expected {n}")
        return arr, end + 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    sd = {}
    si = 0
    se_ratio = None
    policy_kernel = None
    for kind, name in layer_plan(cfg):
        if kind != "fc":
            # Convolution IC OC K, or DepthwiseConvolution 1 C K
            _, ic, oc, ks = structs[si]
            ic, oc, ks = int(ic), int(oc), int(ks)
            si += 1 if kind == "conv" else 2
            kern, pos = read_tensor(oc * ic * ks * ks, pos)
            bias, pos = read_tensor(oc, pos)
            kern = kern.reshape(oc, ic, ks, ks)
            if kind == "conv":
                sd[f"{name}.weight"] = t(kern)
                sd[f"{name}.bias"] = t(bias)
                continue
            mean, pos = read_tensor(oc, pos)
            std, pos = read_tensor(oc, pos)
            zeros = np.zeros(oc, np.float32)
            sd[f"{name}.conv.weight"] = t(kern)
            if kind == "dw_block":
                # the merged kernel and bias go into `conv` with gamma 0;
                # `rep3x3` is zero
                sd[f"{name}.conv.gamma"] = t(zeros)
                sd[f"{name}.conv.bias"] = t(bias)
                sd[f"{name}.rep3x3.weight"] = t(np.zeros((oc, 1, 3, 3), np.float32))
                sd[f"{name}.rep3x3.gamma"] = t(zeros)
                sd[f"{name}.rep3x3.bias"] = t(zeros)
                if name == "policy_dw":
                    # the file does not record the head's kernel: recover it
                    policy_kernel = ks
            sd[f"{name}.bn.beta"] = t(zeros)
            sd[f"{name}.bn.mean"] = t(mean)
            sd[f"{name}.bn.var"] = t(std * std - _EPS)
        else:
            _, isz, osz = structs[si]
            isz, osz = int(isz), int(osz)
            si += 1
            w_, pos = read_tensor(osz * isz, pos)
            bias, pos = read_tensor(osz, pos)
            sd[f"{name}.fc.weight"] = t(w_.reshape(osz, isz))
            sd[f"{name}.fc.bias"] = t(bias)
            if name.endswith(".se.squeeze") and se_ratio is None:
                # the file does not record the SE ratio: recover it
                se_ratio = max(1, cfg.residual_channels // osz)
    if se_ratio is not None and se_ratio != cfg.se_ratio:
        cfg = NetConfig(**{**cfg.__dict__, "se_ratio": se_ratio})
    if policy_kernel is not None and policy_kernel != cfg.policy_head_kernel:
        cfg = NetConfig(**{**cfg.__dict__, "policy_head_kernel": policy_kernel})
    return cfg, sd


def finalize_imported_variables(cfg: NetConfig, state_dict, boardsize=None):
    """Build the SayuriNet of `cfg` (at `boardsize` when given) and load an
    imported state dict into it; batch norms with a gamma get identity.
    Returns (cfg, net) with the net in eval mode."""
    if boardsize is not None:
        cfg = NetConfig(**{**cfg.__dict__, "boardsize": boardsize})
    net = SayuriNet(cfg)
    sd = dict(state_dict)
    for key, ref in net.state_dict().items():
        if key not in sd and key.endswith(".bn.gamma"):
            sd[key] = torch.ones_like(ref)
    net.load_state_dict(sd, strict=True)
    return cfg, net.eval()


_FLAX_NDARRAY, _FLAX_NPSCALAR = 1, 3     # flax's msgpack ext type codes


class _NoClasses(pickle.Unpickler):
    """A JAX-package checkpoint pickles dicts, lists, tuples and scalars,
    and one class: the net config's compute dtype (``jax.numpy.float32``).
    A dtype class comes back as its dotted name, anything else is refused,
    so that no module of JAX is imported."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "numpy", "ml_dtypes"):
            return f"{module}.{name}"
        raise ValueError(f"not a JAX-package trainer checkpoint: it pickles {module}.{name}")


def read_jax_checkpoint(path):
    """(net_cfg dict without the compute dtype, {'params', 'batch_stats'}
    tree of numpy arrays) of a JAX-package trainer checkpoint
    (``Trainer.save_checkpoint``)."""
    import msgpack

    def ndarray(data):
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    def ext(code, data):
        if code == _FLAX_NDARRAY:
            return ndarray(data)
        if code == _FLAX_NPSCALAR:
            return ndarray(data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        blob = _NoClasses(f).load()
    try:
        state = msgpack.unpackb(blob["state"], ext_hook=ext, raw=False)
    except (ValueError, msgpack.UnpackException) as e:
        raise ValueError(f"{path}: not a readable JAX-package trainer checkpoint ({e})") from e
    # the port picks the forward's dtype where it evaluates
    net_cfg = {k: v for k, v in blob["net_cfg"].items() if k != "compute_dtype"}
    return net_cfg, {"params": state["params"], "batch_stats": state["batch_stats"]}


def load_checkpoint_for_inference(path: str, boardsize=None):
    """(NetConfig, SayuriNet in eval mode) from a v5 weight file or from a
    trainer checkpoint (``.ckpt``: its parameters and running statistics,
    not the SWA average), the port's or the JAX package's."""
    if str(path).endswith(".ckpt"):
        with open(path, "rb") as f:
            zipped = f.read(4) == b"PK\x03\x04"       # torch.save's zip container
        over = {"boardsize": boardsize} if boardsize is not None else {}
        if not zipped:
            net_cfg, variables = read_jax_checkpoint(path)
            cfg = NetConfig(**{**net_cfg, "stack": tuple(net_cfg["stack"]), **over})
            return cfg, from_flax_variables(SayuriNet(cfg), variables).eval()
        blob = torch.load(path, map_location="cpu", weights_only=True)
        cfg = NetConfig(**{**blob["net_cfg"], "stack": tuple(blob["net_cfg"]["stack"]), **over})
        net = SayuriNet(cfg)
        net.load_state_dict(blob["model"], strict=True)
        return cfg, net.eval()
    cfg, sd = import_reference_weights(path)
    return finalize_imported_variables(cfg, sd, boardsize)
