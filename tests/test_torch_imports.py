"""The port runs where JAX is absent: importing sayuri_tpu_torch and each
module of the slice pulls in neither jax, flax nor the JAX package, and
chip_smoke.py refuses to run (non-zero, no result line) without a card.

All modules are checked in one fresh interpreter. A ``sys.meta_path``
finder there refuses, and records, every attempt to import ``jax``,
``jaxlib``, ``flax`` or ``sayuri_tpu`` while a module is imported; since a
refused package never enters ``sys.modules``, a later module that imports
it is caught too. Before each module, every ``sayuri_tpu_torch`` module is
dropped from ``sys.modules``, so each one runs its whole import chain as
in an interpreter of its own (only torch and numpy stay loaded)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "sayuri_tpu_torch",
    "sayuri_tpu_torch.game.types",
    "sayuri_tpu_torch.game.board",
    "sayuri_tpu_torch.game.analysis",
    "sayuri_tpu_torch.game.state",
    "sayuri_tpu_torch.game.ladder",
    "sayuri_tpu_torch.ops.analysis",
    "sayuri_tpu_torch.ops.ladder_kernel",
    "sayuri_tpu_torch.ops.build",
    "sayuri_tpu_torch.ops.flood",
    "sayuri_tpu_torch.models.symmetry",
    "sayuri_tpu_torch.models.encoder",
    "sayuri_tpu_torch.models.network",
    "sayuri_tpu_torch.models.weights_io",
    "sayuri_tpu_torch.models.evaluator",
    "sayuri_tpu_torch.mcts.core",
    "sayuri_tpu_torch.mcts.rollout",
    "sayuri_tpu_torch.selfplay",
    "sayuri_tpu_torch.selfplay.randomize",
    "sayuri_tpu_torch.bench",
    "sayuri_tpu_torch.game.sgf",
    "sayuri_tpu_torch.mcts.gumbel",
    "sayuri_tpu_torch.mcts.nncache",
    "sayuri_tpu_torch.selfplay.actor",
    "sayuri_tpu_torch.selfplay.data",
    "sayuri_tpu_torch.selfplay.pipe",
    "sayuri_tpu_torch.config",
    "sayuri_tpu_torch.__main__",
    "sayuri_tpu_torch.mcts.hygiene",
    "sayuri_tpu_torch.game.book",
    "sayuri_tpu_torch.gtp",
    "sayuri_tpu_torch.gtp.time_control",
    "sayuri_tpu_torch.gtp.engine",
    "sayuri_tpu_torch.gtp.loop",
    "sayuri_tpu_torch.train",
    "sayuri_tpu_torch.train.loss",
    "sayuri_tpu_torch.train.dataset",
    "sayuri_tpu_torch.train.pipeline",
    "sayuri_tpu_torch.train.setting",
    "sayuri_tpu_torch.tools",
    "sayuri_tpu_torch.tools.train_worker",
    "sayuri_tpu_torch.tools.rl_loop",
    "sayuri_tpu_torch.native",
    "sayuri_tpu_torch.parallel",
    "sayuri_tpu_torch.parallel.mesh",
    "sayuri_tpu_torch.parallel.distributed",
    "sayuri_tpu_torch.parallel.dryrun",
    "sayuri_tpu_torch.pattern",
    "sayuri_tpu_torch.pattern.pattern",
    "sayuri_tpu_torch.pattern.mm",
    "sayuri_tpu_torch.pattern.gammas",
    "sayuri_tpu_torch.pattern.gammas_device",
    "sayuri_tpu_torch.tools.ab_match",
]

CHECK = """
import importlib, importlib.abc, json, sys, traceback
import numpy, torch

BANNED = ('jax', 'jaxlib', 'flax', 'sayuri_tpu')
attempts = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BANNED:
            attempts.append(name)
            raise ImportError('refused: ' + name)
        return None

sys.meta_path.insert(0, Refuse())
out = {}
for mod in json.loads(sys.argv[1]):
    for m in [m for m in sys.modules if m.split('.')[0] == 'sayuri_tpu_torch']:
        del sys.modules[m]
    attempts.clear()
    err = None
    try:
        importlib.import_module(mod)
    except BaseException:
        err = traceback.format_exc()
    leaked = sorted(m for m in sys.modules if m.split('.')[0] in BANNED)
    out[mod] = {'attempts': sorted(set(attempts)), 'leaked': leaked, 'error': err}
print('RESULT ' + json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def import_results():
    res = subprocess.run([sys.executable, "-c", CHECK, json.dumps(SLICE_MODULES)],
                         capture_output=True, text=True, env=_env(), cwd=ROOT,
                         timeout=300)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    assert res.returncode == 0 and lines, res.stdout + res.stderr
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("mod", SLICE_MODULES)
def test_module_imports_without_jax(mod, import_results):
    r = import_results[mod]
    assert r["error"] is None and not r["attempts"] and not r["leaked"], r


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: exit code non-zero and no result line. (Skips on a
    machine that has a card, where chip_smoke.py is the run itself.)"""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; run chip_smoke.py itself")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), cwd=ROOT,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
