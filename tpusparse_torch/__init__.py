"""tpusparse_torch — the sparse Cholesky solves (superscan, supernodal
and fixed-tile engines), the sparse LU solve (BTF + superscan LU) and
the device SpMV of tpusparse in PyTorch, with hand-written CUDA kernels
for Hopper (sm_90a).

A second package beside ``tpusparse`` (the JAX reference, unchanged).
It imports ``torch`` and never ``jax``, and nothing of ``tpusparse``: it
keeps its own copies of the host half it needs (``core``, ``symbolic``,
``native``, ``numeric.trisolve``, ``utils.profiling``,
``demo.resid_metric``), held to their originals by
tests/test_torch_imports.py.

  tpusparse_torch.core, .symbolic, .native, host containers, BLAS,
    .numeric, .utils                     orderings, dmperm, native planner,
                                         host trisolves, metrics (copies)
  tpusparse_torch.device.superscan_plan, numpy planners of the three
    .supernodal_plan, .chol_plan         Cholesky engines (copies)
  tpusparse_torch.device.superscan, factor / solve on a torch device (and
    .supernodal, .chol_tpu               updown, fixed-tile); cholsol
                                         routes between them
  tpusparse_torch.device.superscan_lu,   sparse LU (superscan, within-panel
    .lu_tpu, .dense                      pivoting), BTF solve, dense LU;
                                         lusol
  tpusparse_torch.device.spmv            SpMV plan (dia / sell / bell /
                                         seg / ell) and apply on a device
  tpusparse_torch.device.kernels         the kernel wrappers + plain versions
  tpusparse_torch.csrc                   the CUDA sources
"""

from .device import (MultifrontalQR, SparseQR, SpmvPlan,
                     SupernodalCholesky, SuperscanCholesky, SuperscanLU,
                     TpuCholesky, TpuLU, TpuQR, cholsol, gaxpy_device,
                     lusol, qrsol, spmv_plan)

__all__ = ["MultifrontalQR", "SparseQR", "SpmvPlan", "SupernodalCholesky",
           "SuperscanCholesky", "SuperscanLU", "TpuCholesky", "TpuLU",
           "TpuQR", "cholsol", "gaxpy_device", "lusol", "qrsol",
           "spmv_plan"]
