"""Buffer generations: how a captured CUDA graph learns that buffers it
reads were replaced.

An object whose device buffers may be replaced after a graph was
captured over them (an ``SpMVPlan``, which ``retile`` rebuilds) carries an
integer ``generation``, raised with each replacement, and calls
:func:`read` wherever a kernel is launched on those buffers. While
``solvers.graphs`` captures a graph, :func:`recording` collects these
reads; before each replay the graph asks :func:`stale`, and captures
again rather than replay over buffers that may have been freed.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

_LOCAL = threading.local()


@contextlib.contextmanager
def recording():
    """Collect the :func:`read` calls made inside the block: yields a dict
    ``id(owner) -> (weak owner, generation)``. A block nested in another
    passes its reads on to the outer one."""
    outer = getattr(_LOCAL, "reads", None)
    reads: dict = {}
    _LOCAL.reads = reads
    try:
        yield reads
    finally:
        _LOCAL.reads = outer
        if outer is not None:
            outer.update(reads)


def read(owner) -> None:
    """Note that a kernel reads ``owner``'s buffers now (a no-op outside
    :func:`recording`)."""
    reads = getattr(_LOCAL, "reads", None)
    if reads is not None:
        reads[id(owner)] = (weakref.ref(owner), owner.generation)


def stale(reads: dict) -> bool:
    """Whether an owner in ``reads`` has moved to another generation since
    it was read, or is gone (its buffers with it)."""
    for ref, gen in reads.values():
        owner = ref()
        if owner is None or owner.generation != gen:
            return True
    return False
