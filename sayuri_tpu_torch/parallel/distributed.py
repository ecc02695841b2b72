"""Multi-process scale-out over ``torch.distributed`` (port of
sayuri_tpu.parallel.distributed).

The JAX package runs one ``jax.distributed`` job, one process a host, each
holding a shard of a global "data" mesh. PyTorch's idiom is one process a
GPU, and the port follows it (a departure): a rank owns one card
(``cuda:LOCAL_RANK``) and its own lanes; collectives run over NCCL on the
card, over gloo when the caller asks for the CPU (the tests do).

Environment contract, read by ``initialize_from_env``:

    SAYURI_COORDINATOR  host:port of rank 0      (or MASTER_ADDR/MASTER_PORT)
    SAYURI_NUM_PROCS    number of processes      (or WORLD_SIZE)
    SAYURI_PROC_ID      this process's rank      (or RANK)
    LOCAL_RANK          this rank's card on its host (default: rank modulo
                        the host's card count)

Without them ``initialize`` is a no-op and returns False, as in the JAX
package. Once they name a group, a failure to join it raises: the process
never carries on alone. The functions below run their collectives whenever
a group exists, at world size 1 too; without a group they are identities.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# seconds a rank waits for the others to join (and for any collective)
DEFAULT_TIMEOUT_S = 600.0


def _env_spec():
    """(coordinator, num_processes, process_id) from the environment, or
    None when it names no group."""
    env = os.environ
    if env.get("SAYURI_COORDINATOR"):
        return (env["SAYURI_COORDINATOR"], int(env["SAYURI_NUM_PROCS"]),
                int(env["SAYURI_PROC_ID"]))
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        return (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    return None


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group (``init_process_group`` over
    ``tcp://coordinator``). Returns True when this process is in a group.

    Arguments left None come from the environment (module docstring); with
    neither, nothing happens and the result is False. ``device`` "cuda"
    selects NCCL and this rank's card (``torch.cuda.set_device``), "cpu"
    selects gloo. Safe to call again: a joined group is kept. Raises when the
    group does not form within ``timeout_s``."""
    if dist.is_initialized():
        return True
    if coordinator is None:
        spec = _env_spec()
        if spec is None:
            return False
        coordinator = spec[0]
        num_processes = spec[1] if num_processes is None else num_processes
        process_id = spec[2] if process_id is None else process_id
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs num_processes and process_id")
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def initialize_from_env(device="cuda") -> bool:
    return initialize(device=device)


def shutdown() -> None:
    """Leave the group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    """More than one rank (the JAX package's name; no caller in the port)."""
    return process_count() > 1


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this rank's card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_lane_slice(global_batch: int) -> slice:
    """The contiguous lanes of a global batch that this rank owns (rank
    order, ``global_batch / world`` each; the JAX package's name, no caller
    in the port: a rank only ever makes its own lanes)."""
    per = global_batch // process_count()
    r = process_index()
    return slice(r * per, (r + 1) * per)


def make_global_batch(mesh, tree):
    """The JAX package assembles a global array from each process's local
    lanes here (its self-play actor's call site). Under one process a GPU a
    rank already holds only its own lanes, and its computation needs no
    others: the identity, which the port's actor does not call."""
    return tree


def local_lanes(x):
    """This rank's lanes of a batch: under one process a GPU, the whole
    local value (the identity; no caller in the port)."""
    return x


def local_batch(x, axis: int, global_b: int):
    """This rank's lanes along `axis`: the identity, as ``local_lanes``
    (no value here is ever global; no caller in the port)."""
    return local_lanes(x)


def _tensors(tree):
    if isinstance(tree, dict):
        return [v for v in tree.values() if isinstance(v, torch.Tensor)]
    return [v for v in tree if isinstance(v, torch.Tensor)]


def broadcast_from_host0(tree):
    """Rank 0's values of every tensor of `tree` (a state dict, or a list of
    tensors), copied in place on every rank: one broadcast a dtype over the
    flattened tensors. Returns `tree`. Without a group: the identity."""
    if not dist.is_initialized():
        return tree
    dev = comm_device()
    by_dtype: dict = {}
    for t in _tensors(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        ts = by_dtype[dtype]
        flat = _flatten_dense_tensors([t.detach().to(dev) for t in ts])
        dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)
    return tree


def broadcast_object_from_host0(obj):
    """Rank 0's value of a picklable object, on every rank. Without a group:
    the object."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=comm_device())
    return box[0]


def all_gather_to_host(tree):
    """Every rank's tensors concatenated on their first dimension in rank
    order (the ranks' shapes must agree), for a dict or a list of tensors;
    the result lies on each input's device. Without a group: the identity."""
    if not dist.is_initialized():
        return tree
    dev, n = comm_device(), dist.get_world_size()

    def gather(t):
        src = t.detach().to(dev).contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src)
        return torch.cat(out).to(t.device)

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return [gather(v) for v in tree]
