from . import config
from .chol_tpu import TpuCholesky, plan_cholesky
from .config import DTYPE
from .refine import refine
from .solvers import cholsol
from .spmv import (SpmvPlan, gaxpy_device, plan_from_numpy, plan_to_numpy,
                   spmv_plan)
from .superscan import (SuperscanCholesky, plan_superscan,
                        pools_from_numpy, pools_to_numpy)
from .supernodal import SupernodalCholesky, plan_supernodal

__all__ = ["config", "DTYPE", "refine", "cholsol", "SuperscanCholesky",
           "plan_superscan", "pools_from_numpy", "pools_to_numpy",
           "SpmvPlan", "spmv_plan", "gaxpy_device", "plan_from_numpy",
           "plan_to_numpy", "SupernodalCholesky", "plan_supernodal",
           "TpuCholesky", "plan_cholesky"]
