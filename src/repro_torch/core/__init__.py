"""Host format construction and the PackSELL / SELL matrices on tensors.

``core/sparse.py`` (the ``csr64`` kind) is not ported yet (ROADMAP.md,
M2)."""
from . import (codecs, delta, packsell, reorder, sell,  # noqa: F401
               testmats, trisolve)
from .packsell import (PackSELLMatrix, packsell_spmm_torch,  # noqa: F401
                       packsell_spmv_torch)
from .sell import SELLMatrix, sell_spmv  # noqa: F401
