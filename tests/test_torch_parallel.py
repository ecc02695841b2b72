"""The port's multi-rank path (``sayuri_tpu_torch.parallel``) on the CPU:
one launch of two gloo ranks does all the group's work, and this process
holds it against one process and against the JAX package.

- The train step: the 9x9 net of the dry run, a seeded batch of 8 boards
  of mixed sizes (so the ranks' on-board counts differ), rank r on rows
  4r:4r+4, from the JAX Trainer's initial variables. One SGD and one AdamW
  step (SWA every step) each equal the port's one-process step and the JAX
  Trainer's step on all 8 rows (its 8-device CPU mesh): loss parts within
  1e-5 relative, parameters, SWA and batch-norm statistics within 1e-5
  absolute. Under AdamW the input conv's centre tap on the mask plane is
  held to |change| <= lr instead, as in test_torch_train_pipeline.py (its
  gradient is rounding noise, which Adam scales to up to lr a step).
- The dry run (``parallel.dryrun``): each all-reduce of the train step
  spans both ranks and together they cover every parameter, counted by a
  wrapper around ``torch.distributed.all_reduce``; each rank's batch is
  half the global one; eight moves of 9x9 self-play on both ranks.
- Self-play (the pipe, 5x5 rounds of 4 moves: the plain ladder twins
  make a 9x9 round cost seconds a move on the CPU, and the dry run's eight
  9x9 moves already play over both ranks): a weightless round on
  each rank, then rank 0 drops a checkpoint of the step's net; both ranks
  reload it (rank 0 decides, the weights are
  broadcast) and hold equal weights, compared through ``all_gather``; each
  rank writes its own ``p{rank}`` chunks, which parse, and plays other
  games (its own seed).
- A join against a dead coordinator raises within its timeout and leaves
  no group.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sayuri_tpu.models.network import NetConfig as JNetConfig
from sayuri_tpu.train.pipeline import TrainConfig as JTrainConfig
from sayuri_tpu.train.pipeline import Trainer as JTrainer
from sayuri_tpu_torch.models.network import NetConfig
from sayuri_tpu_torch.parallel.dryrun import DRYRUN_NET
from sayuri_tpu_torch.train import dataset as TD
from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer
from torch_draws import one_torch_thread  # noqa: F401 (fixture)
from torch_train_util import (assert_parts_close, assert_tensors_close, batch, port_params,
                              port_state, port_stats, to_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
SIZES = (5, 6, 7, 9, 9, 8, 9, 7)
NET = {f: getattr(DRYRUN_NET, f) for f in DRYRUN_NET.__dataclass_fields__}
NET["stack"] = list(NET["stack"])
OPTS = {"sgd": dict(lr_schedule=((0, 0.02),), swa_steps=1),
        "adam": dict(optimizer="Adam", lr_schedule=((0, 1e-3),), swa_steps=1)}

WORKER = r"""
import json, os, sys, time
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from sayuri_tpu_torch.mcts.core import SearchConfig
from sayuri_tpu_torch.models.network import NetConfig
from sayuri_tpu_torch.parallel import distributed as DI, mesh as M
from sayuri_tpu_torch.parallel.dryrun import dryrun_multichip
from sayuri_tpu_torch.selfplay.actor import SelfplayConfig
from sayuri_tpu_torch.selfplay.pipe import SelfPlayPipe
from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer

out, dead_port = sys.argv[1], sys.argv[2]
spec = json.loads(open(os.path.join(out, "spec.json")).read())
rank = int(os.environ["SAYURI_PROC_ID"])
res = {}
assert DI.initialize_from_env(device="cpu")
mesh = M.make_mesh(2)
calls = []
real = dist.all_reduce
def all_reduce(t, *a, **k):
    calls.append((t.numel(), dist.get_world_size(k.get("group"))))
    return real(t, *a, **k)
dist.all_reduce = all_reduce

d = dryrun_multichip(mesh, calls)
res["dryrun"] = {k: d[k] for k in ("loss", "world", "local_batch", "n_params", "all_reduces",
                                   "all_reduced_elements")}
res["dryrun_moves"] = d["moves"].tolist()

# the parent writes the JAX Trainer's initial weights while the ranks start
deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(out, "init.pt")):
    assert time.monotonic() < deadline, "no init.pt"
    time.sleep(0.1)
data = np.load(os.path.join(out, "batch.npz"))
planes = data["planes"]
targets = {k[2:]: data[k] for k in data.files if k.startswith("t_")}
cfg = NetConfig(**{**spec["net"], "stack": tuple(spec["net"]["stack"])})
init = torch.load(os.path.join(out, "init.pt"))
for name, over in spec["opts"].items():
    over = {k: tuple(map(tuple, v)) if k == "lr_schedule" else v for k, v in over.items()}
    tr = Trainer(cfg, TrainConfig(batch_size=8, **over), init_state=init, mesh=mesh)
    calls.clear()
    parts = tr.train_batch(M.shard_batch(mesh, planes), M.shard_batch(mesh, targets))
    torch.save({"parts": parts, "params": tr.unreplicated_params(),
                "stats": tr.unreplicated_batch_stats(), "swa": tr.unreplicated_swa_params(),
                "steps": tr.steps, "samples": tr.samples, "calls": list(calls),
                "rows": int(M.shard_batch(mesh, planes).shape[0])},
               os.path.join(out, f"train_{name}_r{rank}.pt"))

wdir = os.path.join(out, "weights")
pipe = SelfPlayPipe(os.path.join(out, "sp"), boardsize=5, parallel_games=2,
                    search_cfg=SearchConfig(max_nodes=24, gumbel=True),
                    sp_cfg=SelfplayConfig(playouts=4, fastsearch_playouts=2,
                                          fastsearch_playouts_prob=0.0, max_moves_factor=0.16),
                    weights_dir=wdir, device="cpu", mesh=mesh)
pipe.loop(2)
res["weightless"] = pipe.net is None
tr.save_checkpoint(os.path.join(wdir, "net.ckpt"))     # written by rank 0 only
dist.barrier()
pipe.loop(4)
flat = torch.cat([v.reshape(-1).float() for v in pipe.net.state_dict().values()])
both = DI.all_gather_to_host([flat[None]])[0]
res["reload_equal"] = bool(torch.equal(both[0], both[1]))
res["reload_is_ckpt"] = all(torch.equal(pipe.net.state_dict()[k], p)
                            for k, p in tr.unreplicated_params().items())
res.update(run_id=pipe.run_id, games_done=pipe.games_done,
           current_weights=pipe.current_weights, rank=rank, world=mesh.size)
DI.shutdown()
if rank == 1:
    t0 = time.monotonic()
    try:
        DI.initialize("127.0.0.1:" + dead_port, 2, 1, device="cpu", timeout_s=1)
        res["dead_join"] = "joined"
    except Exception as e:
        res["dead_join"] = type(e).__name__
    res["dead_join_s"] = time.monotonic() - t0
    res["dead_join_group"] = dist.is_initialized()
with open(os.path.join(out, f"res_r{rank}.json"), "w") as f:
    json.dump(res, f)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group_run(tmp_path_factory, one_torch_thread):  # noqa: F811
    """Launch the two ranks, compute the references meanwhile, collect."""
    out = tmp_path_factory.mktemp("group")
    jcfg = JNetConfig(**{**NET, "stack": tuple(NET["stack"])})
    tcfg = NetConfig(**{**NET, "stack": tuple(NET["stack"])})
    planes, targets = batch(21, sizes=SIZES, n=9)
    np.savez(out / "batch.npz", planes=planes, **{"t_" + k: v for k, v in targets.items()})
    (out / "spec.json").write_text(json.dumps({"net": NET, "opts": OPTS}))

    env = dict(os.environ, SAYURI_COORDINATOR=f"127.0.0.1:{_free_port()}",
               SAYURI_NUM_PROCS="2", PYTHONPATH=str(ROOT) + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    dead = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(out), dead],
                              env={**env, "SAYURI_PROC_ID": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        jts = {k: JTrainer(jcfg, JTrainConfig(batch_size=8, **o)) for k, o in OPTS.items()}
        init_vars = {"params": jts["sgd"].unreplicated_params(),
                     "batch_stats": jts["sgd"].unreplicated_batch_stats()}
        init = port_state(tcfg, init_vars)
        torch.save(init, out / "init.tmp")
        os.replace(out / "init.tmp", out / "init.pt")
        refs = {}
        for name, over in OPTS.items():
            want = jts[name].train_batch(planes, targets)
            one = Trainer(tcfg, TrainConfig(batch_size=8, **over), device="cpu", init_state=init)
            got = one.train_batch(planes, targets)
            s = jts[name].state
            params, stats = to_numpy(s.params), to_numpy(s.batch_stats)
            refs[name] = {
                "jax_parts": want, "jax_params": port_params(tcfg, params, stats),
                "jax_stats": port_stats(tcfg, params, stats),
                "jax_swa": port_params(tcfg, to_numpy(s.swa_params), stats),
                "jax_counts": (int(s.steps), int(s.samples)),
                "one_parts": got, "one_params": one.unreplicated_params(),
                "one_stats": one.unreplicated_batch_stats(),
                "one_swa": one.unreplicated_swa_params(),
                "init": port_params(tcfg, init_vars["params"], init_vars["batch_stats"])}
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [json.loads((out / f"res_r{r}.json").read_text()) for r in range(2)]
    train = {name: [torch.load(out / f"train_{name}_r{r}.pt") for r in range(2)]
             for name in OPTS}
    return {"out": out, "ranks": ranks, "train": train, "refs": refs}


def _drop_mask_tap(name, got, want, ref):
    """Under AdamW, hold the input conv's centre tap on the mask plane to
    |change| <= lr in both, then leave it out of the 1e-5 comparison."""
    if name != "adam":
        return
    key, tap = "input_conv.conv.weight", (slice(None), 42, 1, 1)
    lr = OPTS[name]["lr_schedule"][0][1]
    for w in (got[key][tap], want[key][tap]):
        assert float((torch.as_tensor(w) - ref["init"][key][tap]).abs().max()) <= lr * 1.001
    got[key] = got[key].clone()
    want[key] = torch.as_tensor(want[key]).clone()
    got[key][tap] = want[key][tap] = 0.0


@pytest.mark.parametrize("name", list(OPTS))
def test_group_step_equals_one_process_and_jax(group_run, name):
    ref = group_run["refs"][name]
    r0, r1 = group_run["train"][name]
    assert r0["rows"] == r1["rows"] == 4
    for k in ("parts", "steps", "samples"):
        assert r0[k] == r1[k], k
    for k in ("params", "stats", "swa"):
        for key in r0[k]:
            assert torch.equal(r0[k][key], r1[k][key]), (k, key)
    assert (r0["steps"], r0["samples"]) == ref["jax_counts"] == (1, 8)
    for tag in ("one", "jax"):
        assert_parts_close(r0["parts"], ref[f"{tag}_parts"], TOL, f"{name} {tag} parts")
        for k in ("params", "swa"):
            got, want = dict(r0[k]), dict(ref[f"{tag}_{k}"])
            _drop_mask_tap(name, got, want, ref)
            assert_tensors_close(got, want, TOL, f"{name} {tag} {k}")
        assert_tensors_close(r0["stats"], ref[f"{tag}_stats"], TOL, f"{name} {tag} statistics")


def test_dryrun_invariants(group_run):
    for r, res in enumerate(group_run["ranks"]):
        d = res["dryrun"]
        assert d["world"] == 2 and d["local_batch"] == 2 and np.isfinite(d["loss"])
        assert d["all_reduced_elements"] >= d["n_params"] > 0
        assert len(res["dryrun_moves"]) == 8 and all(len(m) == 4 for m in res["dryrun_moves"])
    # the train step's all-reduces: every one spans both ranks; one for the
    # gradient, one for the loss parts, four a batch norm
    calls = group_run["train"]["sgd"][0]["calls"]
    n_params = sum(v.numel() for v in group_run["train"]["sgd"][0]["params"].values())
    n_bn = sum(1 for k in group_run["train"]["sgd"][0]["stats"] if k.endswith(".mean"))
    assert all(ranks == 2 for _, ranks in calls)
    assert len(calls) == 2 + 4 * n_bn and max(n for n, _ in calls) == n_params
    assert group_run["ranks"][0]["dryrun"]["all_reduces"] == len(calls)


def test_selfplay_over_two_ranks(group_run):
    r0, r1 = group_run["ranks"]
    assert r0["weightless"] and r1["weightless"]
    assert r0["reload_equal"] and r1["reload_equal"]
    assert r0["reload_is_ckpt"] and r1["reload_is_ckpt"]
    assert r0["current_weights"] == r1["current_weights"]
    assert r0["current_weights"].endswith("net.ckpt")
    assert r0["games_done"] == r1["games_done"] == 4
    assert r0["run_id"].endswith("p0") and r1["run_id"].endswith("p1")
    out = group_run["out"] / "sp"
    texts = {}
    for res in (r0, r1):
        files = sorted(out.glob(f"[tv]data/{res['run_id']}/*.txt.gz"))
        # two games a round; the chunk name counts games within a round, as
        # in the JAX package, so round 2 may replace round 1's files
        assert len(files) >= 2, files
        samples = [s for f in files for s in TD.read_chunk(f)]
        assert samples
        for s in samples:
            s.parse()
            assert s.board_size == 5 and s.planes.shape == (37, 25)
        sgfs = sorted(out.glob(f"sgf/{res['run_id']}_*.sgf"))
        assert len(sgfs) == 4
        texts[res["rank"]] = [p.read_text() for p in sgfs]
        assert (out / "net_queries" / f"{res['run_id']}.txt").exists()
    assert texts[0] != texts[1]


def test_dead_coordinator_raises(group_run):
    r1 = group_run["ranks"][1]
    assert r1["dead_join"] != "joined" and not r1["dead_join_group"]
    assert r1["dead_join_s"] < 60
