"""Guarded execution: fault injection, ABFT checksum guards, recovery.

The port of ``repro.robust``:

* :mod:`.inject` — seeded, deterministic fault injectors for the plan and
  composite operands, input vectors and the precision store file, writing
  in place;
* :mod:`.guard` — structural ``validate_*`` passes and the ABFT checksum
  guard (``c = eᵀA`` at build, ``c·x`` against ``sum(y)`` in fp64 and an
  exact mod-2³² operand checksum on the device per guarded matvec);
* :mod:`.recover` — ``guarded_solve``: refinement with per-step guard
  checks and a bounded escalation policy (retry → promote → rebuild →
  fp32), with a machine-readable recovery log.
"""
from .guard import (GuardState, IntegrityError, build_guard,  # noqa: F401
                    check_integrity, checksum, guarded_spmm, guarded_spmv,
                    is_healthy, mark_unhealthy, plan_health,
                    validate_composite, validate_matrix, validate_plan)
from .inject import (Injection, corrupt_composite_word,  # noqa: F401
                     corrupt_dist_checkpoint, corrupt_fused_checkpoint, corrupt_permutation,
                     corrupt_store, flip_fused_word, flip_pack_word,
                     poison_x)
from .recover import GuardedSolveInfo, guarded_solve  # noqa: F401
