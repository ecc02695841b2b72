"""The port runs where JAX is absent: importing sayuri_tpu_torch and each
module of the slice pulls in neither jax, flax nor the JAX package, and
chip_smoke.py refuses to run (non-zero, no result line) without a card."""

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
]

CHECK = """
import importlib, sys
importlib.import_module({mod!r})
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sayuri_tpu'))
print('LEAKED', bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("mod", SLICE_MODULES)
def test_module_imports_without_jax(mod):
    res = subprocess.run([sys.executable, "-c", CHECK.format(mod=mod)],
                         capture_output=True, text=True, env=_env(), cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


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
