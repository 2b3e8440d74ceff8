"""Build and load the hand-written CUDA kernels (tpusparse_torch/csrc).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into
an object of its own, one process per source, all started together, and
links the objects into one shared library with a plain C interface,
under ``build/tpusparse_torch/`` at the root of the checkout (listed in
.gitignore), keyed by a hash of the flags and of every file in ``csrc/``
(sources and headers); the library is
loaded with ctypes.  What ptxas says of every kernel (registers, shared
memory, spills) goes to ``<library>.log`` beside it.  A missing ``nvcc``
or a failed build raises: there is no fallback.  ``CUDA_HOME`` picks the
toolkit.

Pointers and the stream go to the C entry points as ``c_void_p`` (from
``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``);
each entry point returns ``cudaGetLastError()``, and ``check`` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["NVCC_FLAGS", "library", "check", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "tpusparse_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes; every entry point returns an int (CUDA error)
_ENTRY_POINTS = {
    "tpt_chol_tiles": [_P, _P, _I, _I, _P],
    "tpt_chain_probe": [_P, _I, _I, _P],
    "tpt_lu_tiles": [_P, _P, _P, _I, _I, _F, _F, _P],
    "tpt_lu_tiles_pool": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "tpt_lu_chain_probe": [_P, _I, _I, _P],
    "tpt_lu_empty": [_I, _I, _P],
    "tpt_trsm_tiles_batched": [_P, _P, _P, _I, _I, _I, _P],
    "tpt_trsm_tiles": [_P, _P, _P, _I, _I, _I, _P],
    "tpt_dia_spmv": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tpt_sell_spmv": [_P] * 9 + [_I] * 4 + [_P],
    "tpt_bell_spmv": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tpt_qr_panel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tpt_qr_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tpt_qr_chain_probe": [_P, _I, _I, _P],
    "tpt_qr_apply_chain_probe": [_P, _I, _I, _P],
    "tpt_qr_apply_regime": [_I, _I],
    "tpt_qr_panel_regime": [_I, _I],
}

_lib = None
build_seconds = None        # wall time of this process's nvcc runs, if any


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of tpusparse_torch cannot be built")


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _hashed() -> list:
    """Every file the library is built from: the sources and the headers
    they include, which all lie in csrc/."""
    return sorted(p for p in glob.glob(os.path.join(_CSRC, "*"))
                  if os.path.isfile(p))


def _target() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _hashed():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libtpt_kernels_{h.hexdigest()[:16]}.so")


def _run(cmds: list) -> str:
    """Runs the commands side by side; raises on the first that fails,
    after every one has ended.  Returns what they wrote to stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    fails, said = [], []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        said.append(err)
        if p.returncode != 0:
            fails.append(f"{' '.join(c)} -> {p.returncode}:\n{out}\n{err}")
    if fails:
        raise RuntimeError("nvcc failed:\n" + "\n".join(fails))
    return "".join(said)


def _compile(so: str) -> None:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    nvcc, srcs = _nvcc(), _sources()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    try:
        said = _run([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                     for s, o in zip(srcs, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.tmp", *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    with open(f"{so}.log", "w") as f:
        f.write(said)
    os.replace(f"{tmp}.tmp", so)         # atomic: no half-written library
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    so = _target()
    if not os.path.exists(so):
        _compile(so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.tpt_error_string.argtypes = [_I]
    lib.tpt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib.tpt_error_string(rc).decode() if _lib else ""
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
