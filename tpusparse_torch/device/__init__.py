from . import config
from .chol_tpu import TpuCholesky, plan_cholesky
from .config import DTYPE
from .refine import refine
from .lu_tpu import TpuLU
from .mfqr import MultifrontalQR, plan_mfqr
from .qr_tpu import SparseQR, TpuQR
from .solvers import cholsol, lusol, qrsol
from .spmv import (SpmvPlan, gaxpy_device, plan_from_numpy, plan_to_numpy,
                   spmv_plan)
from .superscan import (SuperscanCholesky, plan_superscan,
                        pools_from_numpy, pools_to_numpy)
from .supernodal import SupernodalCholesky, plan_supernodal
from .superscan_lu import SuperscanLU

__all__ = ["config", "DTYPE", "refine", "cholsol", "SuperscanCholesky",
           "plan_superscan", "pools_from_numpy", "pools_to_numpy",
           "SpmvPlan", "spmv_plan", "gaxpy_device", "plan_from_numpy",
           "plan_to_numpy", "SupernodalCholesky", "plan_supernodal",
           "TpuCholesky", "plan_cholesky", "lusol", "TpuLU",
           "SuperscanLU", "qrsol", "MultifrontalQR", "plan_mfqr", "TpuQR",
           "SparseQR"]
