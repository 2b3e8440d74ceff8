from .bell_spmv import bell_spmv, bell_spmv_ref
from .chol_tile import chol_tiles, chol_tiles_ref
from .dia_spmv import dia_spmv, dia_spmv_ref
from .lu_tile import (lu_tiles, lu_tiles_pool, lu_tiles_pool_ref,
                      lu_tiles_ref)
from .sell_spmv import (sell_pack, sell_slab_ref, sell_spmv,
                        sell_spmv_ref)
from .trsm_tile import (trsm_tiles, trsm_tiles_batched,
                        trsm_tiles_batched_ref, trsm_tiles_blocked_ref,
                        trsm_tiles_ref)

__all__ = ["bell_spmv", "bell_spmv_ref", "chol_tiles", "chol_tiles_ref",
           "dia_spmv", "dia_spmv_ref", "lu_tiles", "lu_tiles_ref",
           "lu_tiles_pool", "lu_tiles_pool_ref",
           "sell_pack", "sell_slab_ref",
           "sell_spmv", "sell_spmv_ref",
           "trsm_tiles", "trsm_tiles_ref", "trsm_tiles_batched",
           "trsm_tiles_batched_ref", "trsm_tiles_blocked_ref"]
