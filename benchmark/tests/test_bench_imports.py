"""What a run loads: no JAX and nothing of the JAX package, compared by
whole top-level names (``tpusparse_torch`` begins with ``tpusparse``);
the references load nothing of the program either; nothing in the
benchmark imports ``chip_smoke.py``."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpusparse"}


def _modules(kind: str) -> list:
    return sorted(glob.glob(os.path.join(BENCH_DIR, kind, "*.py")))


def _loaded_after(paths: list) -> set:
    """Top-level names in sys.modules of a fresh interpreter that has
    loaded the runner's package and the files at ``paths``."""
    mods = [(os.path.relpath(p, ROOT)[:-3].replace(os.sep, "."), p)
            for p in paths]
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import benchmark.harness, benchmark.trace\n"
        f"for name, p in {mods!r}:\n"
        "    spec = importlib.util.spec_from_file_location(name, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    paths = [os.path.join(BENCH_DIR, "run.py")]
    for kind in ("matrices", "ops", "reference", "metrics"):
        paths += _modules(kind)
    loaded = _loaded_after(paths)
    assert "tpusparse_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    loaded = _loaded_after(_modules("reference"))
    assert not loaded & (FORBIDDEN | {"tpusparse_torch"})


def test_no_file_imports_chip_smoke_or_jax():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & (FORBIDDEN | {"chip_smoke"}), path
