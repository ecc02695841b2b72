"""Multi-host scaffolding test: a REAL 2-process jax.distributed job on
the CPU backend (gloo collectives), validating the TPU-native actor/
learner scale-out path (SURVEY.md §2.10 P3/P7; the reference's
filesystem-rendezvous equivalent is engine.cc:63-90):

- jax.distributed.initialize via sayuri_tpu.parallel.distributed
- a global mesh spanning both processes
- make_global_batch: per-host lanes -> one batch-sharded global array
- a jitted cross-host reduction over the global array
- broadcast_from_host0: learner -> actor weight refresh
- local_lanes: each host reads back exactly its own lanes
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["SAYURI_COORDINATOR"] = f"localhost:{port}"
os.environ["SAYURI_NUM_PROCS"] = "2"
os.environ["SAYURI_PROC_ID"] = str(pid)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from sayuri_tpu.parallel import distributed as DI

assert DI.initialize_from_env()
assert jax.process_count() == 2 and jax.device_count() == 4
mesh = DI.global_mesh()

# per-host lanes -> global batch-sharded array (4 lanes/host, 8 global)
local = np.arange(4.0, dtype=np.float32) + 100.0 * pid
batch = DI.make_global_batch(mesh, {"x": local})
assert batch["x"].shape == (8,)

# jitted cross-host reduction: sum over the global batch rides the fabric
total = jax.jit(jnp.sum)(batch["x"])
expected = float(np.arange(4).sum() * 2 + 100.0 * 4)
assert abs(float(total) - expected) < 1e-6, (float(total), expected)

# learner -> actor refresh: host 0's params win everywhere
params = {"w": np.full((3,), float(pid), np.float32)}
synced = DI.broadcast_from_host0(params)
assert np.allclose(np.asarray(synced["w"]), 0.0)

# writer path: each host sees exactly its own lanes, in order
mine = DI.local_lanes(batch["x"])
assert np.allclose(mine, local), (mine, local)

# [T, B] target-style array sharded on dim 1
tb = jnp.stack([batch["x"], batch["x"] + 1000.0])
mine_tb = DI.local_lanes(tb)
assert mine_tb.shape == (2, 4) and np.allclose(mine_tb[0], local)

print(f"OK proc {pid}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_distributed(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"OK proc {pid}" in out
