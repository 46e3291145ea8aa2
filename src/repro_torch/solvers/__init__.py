"""Mixed-precision Krylov solvers over the port's SpMV."""
from . import cg, f3r, gmres, iocg, operators, precond, richardson  # noqa: F401
from .cg import adaptive_pcg, fcg, pcg, pcg_fixed_iters  # noqa: F401
from .gmres import fgmres, fgmres_fixed_cycles  # noqa: F401
from .operators import OperatorSet, row_scale, sym_scale  # noqa: F401
from .precond import neumann_ainv  # noqa: F401
from .richardson import richardson_fixed_iters  # noqa: F401
