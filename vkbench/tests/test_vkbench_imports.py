"""Nothing the benchmark runs imports JAX or the JAX package; names are
compared by whole top-level name, since the program's own name begins
with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from vkbench import run

VKBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("modules, found", [
    ({"vkvolume_tpu_torch", "vkvolume_tpu_torch.engine", "numpy"}, []),
    ({"vkvolume_tpu.engine", "numpy"}, ["vkvolume_tpu"]),
    ({"jax.numpy", "jaxlib", "flax.linen"}, ["flax", "jax", "jaxlib"]),
    ({"jaxtyping", "flaxen", "vkvolume_tpuX"}, []),
])
def test_forbidden_modules_whole_names(modules, found):
    assert run.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(VKBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "roofline.py", "data.py",
                 "pose.py", "generator.py"):
        tops = {m.split(".")[0] for m in _imports(
            os.path.join(VKBENCH, name))}
        assert "vkvolume_tpu_torch" not in tops, name


def test_run_loads_no_jax():
    """A whole run of a cell in a fresh process (the CPU, a tiny size)
    leaves none of the forbidden packages in ``sys.modules``."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "sys.path.insert(0, '.')\n"
        "from vkbench import run\n"
        "res, _ = run.run_cell('snake-tfb-iso.still', 3, 0.5, False,"
        " device='cpu', scale=0.05, size=(128, 128))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'vkvolume_tpu')))\n"
        "assert 'vkvolume_tpu_torch' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
