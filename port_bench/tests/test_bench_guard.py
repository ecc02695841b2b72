"""The import guard: a dry import of the harness, every driver and the
modules of the measured program the drivers reach loads no module of JAX
or of the JAX package, and the reference imports nothing of the measured
program."""

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sayuri_tpu"}


def test_dry_import_loads_no_jax():
    code = ("import sys, pathlib; sys.path.insert(0, %r)\n"
            "import port_bench.run as r, port_bench.control\n"
            "for p in sorted(pathlib.Path(%r).glob('*.py')):\n"
            "    __import__('port_bench.drivers.' + p.stem)\n"
            "import sayuri_tpu_torch.selfplay.actor, sayuri_tpu_torch.models.evaluator\n"
            "import sayuri_tpu_torch.config, sayuri_tpu_torch.game.ladder\n"
            "print(r.forbidden_modules())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (str(ROOT), str(ROOT / "port_bench" / "drivers")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout.splitlines()
    assert out[0] == "[]"
    loaded = set(eval(out[1]))
    assert not loaded & FORBIDDEN and "sayuri_tpu_torch" in loaded


def test_forbidden_names_are_whole_top_level_names():
    from port_bench import run as RUN

    sys.modules.setdefault("sayuri_tpu_torch_probe", sys)
    try:
        assert RUN.forbidden_modules() == sorted(
            {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
        assert "sayuri_tpu_torch_probe" not in RUN.forbidden_modules()
    finally:
        del sys.modules["sayuri_tpu_torch_probe"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "port_bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"sayuri_tpu_torch"}, (path.name, n)
