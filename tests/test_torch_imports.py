"""tpusparse_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax or any module of the JAX package tpusparse,
and its copies of JAX package modules differ from their originals only
by removed lines and rewritten imports."""

import ast
import difflib
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tpusparse_torch")
FORBIDDEN = ("jax", "jaxlib", "tpusparse")


def _port_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _package_of(path):
    """Dotted package that a relative import in ``path`` starts from."""
    rel = os.path.relpath(os.path.dirname(os.path.abspath(path)), ROOT)
    return [] if rel == "." else rel.split(os.sep)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:                   # resolve against the file
                pkg = _package_of(path)
                up = pkg[:len(pkg) - node.level + 1]
                base = ".".join(up + ([node.module] if node.module
                                      else []))
            yield base
            for a in node.names:         # from tpusparse import device
                yield f"{base}.{a.name}"


def _forbidden(mod):
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports():
    files = list(_port_files())
    assert len(files) >= 20
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("src,want", [
    ("def f():\n    from tpusparse import device\n"
     "    import jax.numpy as jnp\n", ["jax.numpy", "tpusparse",
                                      "tpusparse.device"]),
    ("from tpusparse.core import X\n", ["tpusparse.core",
                                        "tpusparse.core.X"]),
    ("import tpusparse\n", ["tpusparse"]),
    ("import tpusparse_torch\nfrom tpusparse_torch.core import CSCMatrix\n"
     "from .core import gaxpy\n", []),
])
def test_scan_catches_forbidden_import(tmp_path, src, want):
    p = tmp_path / "m.py"
    p.write_text(src)
    assert sorted(m for m in _imported_modules(str(p))
                  if _forbidden(m)) == want


def test_relative_imports_resolve_inside_the_port():
    path = os.path.join(PORT, "device", "spmv.py")
    mods = set(_imported_modules(path))
    assert {"tpusparse_torch.core.matrix", "tpusparse_torch.device.kernels",
            "tpusparse_torch.device.kernels.sell_spmv"} <= mods


def test_import_does_not_load_jax():
    """A fresh interpreter imports the port, plans a superscan, a
    supernodal and a fixed-tile factor and an SpMV (sell, after RCM),
    solves with lusol, factors a SuperscanLU and solves with qrsol on its
    three routes on the CPU, and has loaded neither jax nor any module of
    tpusparse."""
    code = (
        "import sys\n"
        "pre = 'jax' in sys.modules\n"
        "import numpy as np\n"
        "import tpusparse_torch, tpusparse_torch.device.kernels\n"
        "from tpusparse_torch.core import csc_from_dense\n"
        "from tpusparse_torch.device import plan_superscan\n"
        "rng = np.random.default_rng(0)\n"
        "d = (rng.random((300, 300)) < 0.02) * rng.normal(size=(300, 300))\n"
        "d = d + d.T + 10 * np.eye(300)\n"
        "A = csc_from_dense(d)\n"
        "assert plan_superscan(A, order=1).lnz > 0\n"
        "from tpusparse_torch.device import plan_cholesky, "
        "plan_supernodal\n"
        "assert plan_supernodal(A, order=1).lnz > 0\n"
        "assert plan_cholesky(A, order=1).nb > 0\n"
        "p = tpusparse_torch.spmv_plan(A, 'sell', device='cpu')\n"
        "assert np.allclose(p.apply(np.ones(300)).numpy(), d.sum(1),\n"
        "                   atol=1e-4)\n"
        "assert tpusparse_torch.lusol(1, A, np.ones(300), device='cpu')[0]\n"
        "assert tpusparse_torch.SuperscanLU(A, device='cpu').factor()\n"
        "import os\n"
        "T = csc_from_dense(d[:, :120])\n"
        "for env in ({}, {'TPUSPARSE_QR_DENSE_MAX': '100'},\n"
        "            {'TPUSPARSE_QR_ENGINE': 'csne'}):\n"
        "    os.environ.update(env)\n"
        "    assert tpusparse_torch.qrsol(3, T, np.ones(300),\n"
        "                                 device='cpu')[0]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'tpusparse'))\n"
        "print(pre, bad == [], bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pre, clean = r.stdout.split()[:2]
    if pre == "True":
        pytest.skip("the interpreter loads jax at startup")
    assert clean == "True", r.stdout


def _lines(spec):
    """Lines of ``path`` or, for ``path::name``, of its top-level
    function or class ``name`` (``Class.method`` for a method)."""
    path, _, name = spec.partition("::")
    src = open(os.path.join(ROOT, path)).read()
    if name:
        body = ast.parse(src).body
        for part in name.split("."):
            node = next(n for n in body
                        if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                        and n.name == part)
            body = node.body
        src = ast.get_source_segment(src, node)
    return src.splitlines()


def _added_lines(orig, copy):
    diff = difflib.unified_diff(_lines(orig), _lines(copy), lineterm="",
                                n=0)
    return [ln[1:] for ln in diff
            if ln.startswith("+") and not ln.startswith("+++")]


# the one non-import change a copy carries: the native planner library
# is built under build/tpusparse_torch/, never inside the package
_NATIVE_BUILD = (
    '_SO = os.path.join(_HERE, "../../build/tpusparse_torch/'
    'libtsplanner.so")',
    '        os.makedirs(os.path.dirname(_SO), exist_ok=True)')
_COPIES = [
    ("tpusparse/device/superscan.py",
     "tpusparse_torch/device/superscan_plan.py"),
    ("tpusparse/device/refine.py", "tpusparse_torch/device/refine.py"),
    ("tpusparse/device/chol_tpu.py::_scalar_row_patterns",
     "tpusparse_torch/device/patterns.py::_scalar_row_patterns"),
    ("tpusparse/device/supernodal.py::_column_patterns",
     "tpusparse_torch/device/patterns.py::_column_patterns"),
    ("tpusparse/core/matrix.py", "tpusparse_torch/core/matrix.py"),
    ("tpusparse/core/ops.py", "tpusparse_torch/core/ops.py"),
    ("tpusparse/core/perm.py", "tpusparse_torch/core/perm.py"),
    ("tpusparse/core/filter.py", "tpusparse_torch/core/filter.py"),
    ("tpusparse/symbolic/etree.py", "tpusparse_torch/symbolic/etree.py"),
    ("tpusparse/symbolic/amd.py", "tpusparse_torch/symbolic/amd.py"),
    ("tpusparse/symbolic/rcm.py", "tpusparse_torch/symbolic/rcm.py"),
    ("tpusparse/native/__init__.py", "tpusparse_torch/native/__init__.py"),
    ("tpusparse/native/planner.cpp", "tpusparse_torch/native/planner.cpp"),
    ("tpusparse/demo.py", "tpusparse_torch/demo.py"),
    *[(f"tpusparse/device/formats.py::{name}",
       f"tpusparse_torch/device/formats.py::{name}")
      for name in ("EllMatrix", "BellMatrix", "DiaMatrix", "dia_offsets",
                   "to_dia", "to_ell")],
    ("tpusparse/device/spmv.py::_heavy_tail",
     "tpusparse_torch/device/spmv.py::_heavy_tail"),
    *[(f"tpusparse/device/supernodal.py::{name}",
       f"tpusparse_torch/device/supernodal_plan.py::{name}")
      for name in ("_pow2", "_split_widths", "_Snode", "SupernodalPlan",
                   "plan_supernodal")],
    *[(f"tpusparse/device/chol_tpu.py::{name}",
       f"tpusparse_torch/device/chol_plan.py::{name}")
      for name in ("_tile_pattern", "CholPlan", "plan_cholesky")],
    *[(f"tpusparse/symbolic/{name}.py", f"tpusparse_torch/symbolic/{name}.py")
      for name in ("reach", "dmperm", "transversal")],
    ("tpusparse/numeric/trisolve.py", "tpusparse_torch/numeric/trisolve.py"),
    *[(f"tpusparse/utils/profiling.py::{name}",
       f"tpusparse_torch/utils/profiling.py::{name}")
      for name in ("Timer", "Metrics", "flop_report")],
    ("tpusparse/device/superscan_lu.py::SuperscanLU._scatter_values",
     "tpusparse_torch/device/superscan_lu.py::SuperscanLU._scatter_values"),
    ("tpusparse/symbolic/plan.py", "tpusparse_torch/symbolic/plan.py"),
    *[(f"tpusparse/numeric/{name}.py", f"tpusparse_torch/numeric/{name}.py")
      for name in ("chol", "lu", "qr", "solvers")],
    *[(f"tpusparse/device/mfqr.py::{name}",
       f"tpusparse_torch/device/mfqr_plan.py::{name}")
      for name in ("_padded_flops", "_cluster_shapes", "_ground", "_Front",
                   "MfqrPlan", "plan_mfqr")],
]


@pytest.mark.parametrize("orig,copy", _COPIES)
def test_copies_only_remove_lines_and_rewrite_imports(orig, copy):
    added = _added_lines(orig, copy)
    allowed = _NATIVE_BUILD if copy.startswith("tpusparse_torch/native/") \
        else ()
    assert _lines(copy), "the copy must not be empty"
    for ln in added:
        if ln in allowed:
            continue
        s = ln.strip()
        assert s.startswith(("from ", "import ")), ln
        assert "tpusparse" not in s.split(" import ")[0], ln


# ------------------------------------------------ the kernel library's key
_CSRC = os.path.join(PORT, "csrc")


@pytest.mark.parametrize("name", sorted(os.listdir(_CSRC)))
def test_every_csrc_file_feeds_the_library_key(tmp_path, monkeypatch, name):
    """An edit to any file under csrc/ (a source or a header it includes)
    must change the name of the library, or the edit would not rebuild."""
    import re
    import shutil

    from tpusparse_torch.device.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    before = _build._target()
    assert before == _build._target()
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    assert _build._target() != before
    # every #include "..." of a source names a file of csrc/
    with open(os.path.join(_CSRC, name)) as f:
        for inc in re.findall(r'#include\s+"([^"]+)"', f.read()):
            assert os.path.isfile(os.path.join(_CSRC, inc)), inc
