"""Host format construction and the PackSELL / SELL / CSR matrices on
tensors."""
from . import (codecs, delta, packsell, reorder, sell,  # noqa: F401
               sparse, testmats, trisolve)
from .packsell import (PackSELLMatrix, packsell_spmm_torch,  # noqa: F401
                       packsell_spmv_torch)
from .sell import SELLMatrix, sell_spmv  # noqa: F401
