"""CUDA graphs for the solver loops: the port's counterpart of ``jax.jit``.

The reference compiles each solver loop (``lax.while_loop``,
``lax.fori_loop``) into one XLA computation. The port captures the same
step functions into CUDA graphs and replays them, so a step costs its
kernels' device time and no host launch per op.

A :class:`Graph` wraps a step function ``body()`` that reads and writes
tensors it closes over (its static buffers, allocated outside any
capture) and returns a tensor, a tuple of tensors or None. On the card:

- call 1 runs the body eagerly on a side stream (the warm-up, which also
  gives cuBLAS its workspace on that stream) and returns its results;
  then it captures the body, with copies of its results into output
  buffers allocated outside the capture, into a CUDA graph in the pool
  its owner gives it;
- every later call replays the graph and returns the output buffers.

A returned buffer holds until the graph's next call: a caller that keeps
the value longer clones it. Everything that outlives a replay lives
outside the pool, so the graphs of one solve can share it in any order.

Called from another graph's body (while it warms up or is captured), a
graph runs its body inline, and so becomes part of the outer graph. On
the CPU there is nothing to capture: call 1 runs the body, later calls
run it again as a replay would and copy its results into the output
buffers, so the buffer rules are the same and the CPU tests see them. A
capture that fails raises; nothing falls back to eager ops on the card.

Inside :func:`eager` every solver runs its eager loop instead: each op
launched from the host, the stopping loops reading their flag after each
step. It is the port's form of running the reference without ``jit``,
and the tests and ``chip_smoke.py`` hold the graphs to it.

A graph may be destroyed only while nothing is being captured, so no
graph may sit in a reference cycle, where the garbage collector would
free it at any moment, another capture included: an object that owns
its graphs hands them its methods through :func:`method`, and the
collector is off while a graph is captured.

A graph captured over buffers that their owner has replaced since (a
plan's ``retile``: :mod:`repro_torch._generations`) is captured again at
its next call instead of replayed.

A replay makes no Python call, so counters of calls (the kernel
wrappers' launches, a test's matvec counts) see only the warm-up and the
capture. :data:`LEDGER` keeps the difference: each capture records the
calls it made in the watched counters, and each replay adds them again.
The flight recorder (:mod:`repro_torch.observe`) records nothing inside a
body (warm-up, capture or CPU run), as the reference records nothing
inside a traced body; ``observe.report()`` carries the ledger's replays.

PyTorch captures in ``capture_error_mode="global"``: an allocation or a
sync that another thread issues while a graph is captured invalidates
the capture. :data:`CAPTURE_LOCK` is held around every warm-up and
capture; a thread that runs device work beside the solvers (the serving
front end's background worker) holds it around each task.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import threading
import weakref
from typing import Callable, Mapping

import torch

from .. import _generations
from ..observe import metrics as _obs


class Ledger:
    """What graph replays ran, in the units of watched counters.

    ``watch(source)`` adds a callable returning ``{name: count}`` (names
    unique across sources) while its block runs. A capture records the
    rise of every watched count during it (calls recorded, not run) and
    subtracts it from :attr:`net`; a replay adds it. So ``count + net``
    is what ran: eager calls, warm-ups and replays."""

    def __init__(self):
        self.sources: list = []
        self.net = collections.Counter()
        self.replays = 0                     # graph replays, ever
        self.replayed = collections.Counter()   # watched calls they ran

    @contextlib.contextmanager
    def watch(self, source: Callable[[], Mapping[str, int]]):
        self.sources.append(source)
        try:
            yield self
        finally:
            self.sources.remove(source)

    def snapshot(self) -> collections.Counter:
        out = collections.Counter()
        for src in self.sources:
            out.update(src())
        return out

    def ran(self, counts: Mapping[str, int]) -> dict:
        """``counts`` (a watched source's values) plus the replays' net."""
        return {k: v + self.net[k] for k, v in counts.items()}


#: the process's ledger (the kernel wrappers' launch counts are
#: module-level too)
LEDGER = Ledger()

_MODE = threading.local()       # .eager: inside eager(); .depth: bodies
                                # running now (a warm-up, a capture or a
                                # CPU run)
_SIDE: dict = {}                # device index -> the warm-up/capture stream

#: held around every warm-up and capture, and by any other thread around
#: device work that may run while a graph is captured (module docstring)
CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def eager():
    """Run the solvers' eager loops inside the block (module docstring)."""
    before = is_eager()
    _MODE.eager = True
    try:
        yield
    finally:
        _MODE.eager = before


def is_eager() -> bool:
    return getattr(_MODE, "eager", False)


def inline(device: torch.device) -> bool:
    """Whether a graph called now runs its body inline: inside
    :func:`eager`, or inside another graph's body as it runs (a warm-up, a
    capture or a CPU run), or while the stream captures."""
    return is_eager() or getattr(_MODE, "depth", 0) > 0 or (
        device.type == "cuda" and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def _body():
    _MODE.depth = getattr(_MODE, "depth", 0) + 1
    try:
        with _obs.quiet():
            yield
    finally:
        _MODE.depth -= 1


def method(bound) -> Callable:
    """``bound`` (a bound method) called through a weak reference to its
    object: a body for a graph that the object owns, without a cycle."""
    ref = weakref.WeakMethod(bound)
    return lambda *args, **kwargs: ref()(*args, **kwargs)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SIDE:
        _SIDE[idx] = torch.cuda.Stream(device=idx)
    return _SIDE[idx]


def _flat(res) -> tuple:
    if res is None:
        return ()
    return (res,) if torch.is_tensor(res) else tuple(res)


class Pool:
    """One graph memory pool, made at the first capture that uses it:
    the graphs of one solve share it."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class Graph:
    """``body()`` as a CUDA graph on ``device`` (module docstring)."""

    def __init__(self, body: Callable[[], object], device: torch.device,
                 pool: Pool | None = None):
        self.body = body
        self.device = torch.device(device)
        self.pool = pool or Pool()
        self.graph = None
        self.out = None          # output buffers, made before the capture
        self._single = False
        self.calls = collections.Counter()  # watched calls per replay
        self.replays = 0
        self.reads: dict = {}    # the buffer owners the capture read

    def _run(self):
        """One run of the body: the warm-up, the capture, or a CPU run."""
        with _body():
            return self.body()

    def _buffers(self, res) -> None:
        self._single = torch.is_tensor(res)
        self.out = tuple(torch.empty_like(r) for r in _flat(res))

    def _result(self):
        if self._single:
            return self.out[0]
        return self.out if self.out else None

    def __call__(self):
        if inline(self.device):
            return self.body()
        if self.device.type != "cuda":
            return self._cpu_call()
        if self.graph is None or _generations.stale(self.reads):
            self.graph = None
            with CAPTURE_LOCK:
                return self._warm_up_and_capture()
        self.graph.replay()
        self.replays += 1
        LEDGER.net.update(self.calls)
        LEDGER.replays += 1
        LEDGER.replayed.update(self.calls)
        return self._result()

    def _cpu_call(self):
        res = self._run()
        if self.out is None:
            self._buffers(res)
            return res
        for o, r in zip(self.out, _flat(res)):
            o.copy_(r)
        self.replays += 1
        return self._result()

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            res = self._run()
        cur.wait_stream(side)
        for r in _flat(res):
            r.record_stream(cur)
        self._buffers(res)
        graph = torch.cuda.CUDAGraph()
        before = LEDGER.snapshot()
        side.wait_stream(cur)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(side), \
                    _generations.recording() as reads:
                graph.capture_begin(pool=self.pool.handle())
                try:
                    for o, r in zip(self.out, _flat(self._run())):
                        o.copy_(r)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        self.calls = LEDGER.snapshot() - before
        LEDGER.net.subtract(self.calls)
        self.graph, self.reads = graph, reads
        return res


class Applied:
    """``fn(v)`` of one tensor as a graph per input shape, dtype and
    device: the input is copied into the graph's static buffer, and the
    result comes back cloned, so it is the caller's. Where a graph runs
    inline (:func:`inline`), ``fn`` runs on ``v``."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        self.fn = fn
        self.graphs: dict = {}
        self.pool = Pool()

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if inline(v.device):
            return self.fn(v)
        key = (tuple(v.shape), v.dtype, v.device)
        ent = self.graphs.get(key)
        if ent is None:
            vs = torch.empty_like(v, memory_format=torch.contiguous_format)
            ent = (vs, Graph(functools.partial(self.fn, vs), v.device,
                             self.pool))
            self.graphs[key] = ent
        ent[0].copy_(v)
        return ent[1]().clone()
