"""Op-level cost model of one eager call: the port's counterpart of the
reference's ``repro/launch/hlo_cost.py``.

The reference parses the optimized HLO of a jitted step and sums its
instructions' costs, loop bodies times their trip counts. The port has
no HLO: a step is the aten ops its Python code dispatches, each Python
loop (over layers, chunks, microbatches) unrolled as it runs. So the HLO
parser is not ported. Instead :class:`OpCost`, a ``TorchDispatchMode``,
sees every aten op of a call, on meta, CPU or CUDA tensors alike (the
same call gives the same counts on each), and counts per op:

* **FLOPs** by ``torch.utils.flop_counter``'s registered formulas (the
  matmul family, convolutions, the fused attention kernels): the
  reference's "dot FLOPs" rule. An op without a formula that decomposes
  is counted by its pieces, as ``FlopCounterMode`` does, so the total
  equals ``FlopCounterMode``'s.
* **Bytes**: the sizes of the tensor inputs and outputs of each op that
  is neither a view or alias of an input nor an allocation (the
  reference's ``_SKIP_BYTES`` for bitcasts, tuples and parameters). The
  eager step is not fused, so these are the bytes it moves at kernel
  boundaries; the reference counts after XLA's fusion, so its bytes are
  not comparable with these.
* **Transcendentals**: the output elements of ``exp``, ``log``, ``tanh``,
  ``rsqrt``, ``sqrt``, ``pow``, ``sin``, ``cos``, ``sigmoid``, ``erf`` and
  ``atan2`` (the reference's ``_TRANSCENDENTAL``; ops that compute one
  inside, such as ``_softmax`` or ``silu``, are not counted).
* Not counted, nor in the live bytes: transfers, copies from another
  device (a host constant sent to the card, or to meta, often once and
  cached);
  ``lift_fresh``, which marks a tensor made from host data on the CPU
  only. So a call counts the same ops on each device.
* **The call site**: the innermost frame under ``repro_torch`` (not this
  module), ``path:line function``; ops the autograd engine runs outside
  any such frame are ``<backward>``.

On one device there are no collectives: ``collectives`` is empty and
``collective_bytes`` 0, with the reference's keys. The mode also follows
the storages the call allocates (a weak reference on each output tensor)
and keeps the peak of their live bytes: what the eager call holds above
its arguments, counted from shapes; and it keeps the storages that some
counted op reads (``read``), so that a caller can tell which of its
arguments the call touches at all (:func:`read_bytes`).

    cost = op_cost.aggregate(step, params, batch)
"""
from __future__ import annotations

import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_SELF = os.path.abspath(__file__)

_TRANSCENDENTAL = frozenset(
    n + s for n in ("exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sin",
                    "cos", "sigmoid", "erf", "atan2") for s in ("", "_"))
#: allocations: they move no bytes
_ALLOC = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                    "new_empty_strided"))
#: copies: one whose source lies on another device than its result is a
#: transfer (a host constant sent to the card or to meta), not a device op
_COPIES = frozenset(("_to_copy", "copy_", "_copy_from",
                     "_copy_from_and_resize"))
#: marks a tensor made from host data (``torch.tensor``, ``new_tensor``) on
#: the CPU; the meta and CUDA factories dispatch none
_LIFT = frozenset(("lift_fresh", "lift_fresh_copy"))
#: metadata queries that ``FlopCounterMode`` passes on
_QUERIES = frozenset(
    getattr(torch.ops.aten, n).default for n in (
        "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
        "is_non_overlapping_and_dense", "size", "sym_size", "stride",
        "sym_stride", "storage_offset", "sym_storage_offset", "numel",
        "sym_numel", "dim")
    if hasattr(torch.ops.aten, n)) | {torch.ops.prim.layout.default}

BACKWARD = "<backward>"
OUTSIDE = "<outside repro_torch>"


def _is_view(func) -> bool:
    """Whether ``func`` returns a view or alias of an input (a return
    with alias information that is not an in-place write)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts the aten ops dispatched inside ``with OpCost() as oc:``;
    ``oc.rows`` maps ``(op, site)`` to ``[count, flops, bytes,
    transcendentals]``."""

    def __init__(self):
        super().__init__()
        self.rows: dict = {}
        self._sites: dict = {}
        self._refs: dict = {}
        self._sizes: dict = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.read: set = set()

    # -- where an op was called ------------------------------------------
    def _site(self) -> str:
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            rel = self._sites.get(code)
            if rel is None:
                fn = os.path.abspath(code.co_filename)
                rel = (fn[len(_PKG):] if fn.startswith(_PKG) and fn != _SELF
                       else "")
                self._sites[code] = rel
            if rel:
                return f"{rel}:{f.f_lineno} {code.co_name}"
            if code.co_name == "_engine_run_backward":
                return BACKWARD
            f = f.f_back
        # the autograd engine's device threads hold no Python frame of ours
        return BACKWARD if torch._C._current_graph_task_id() != -1 \
            else OUTSIDE

    # -- live storages ----------------------------------------------------
    def _drop(self, key) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live_bytes -= self._sizes.pop(key)

    def _follow(self, outs, ins) -> None:
        inputs = None
        for o in outs:
            key = o.untyped_storage()._cdata
            if key not in self._refs:
                if inputs is None:
                    inputs = {t.untyped_storage()._cdata for t in ins}
                if key in inputs:           # an argument's storage
                    continue
                size = o.untyped_storage().nbytes()
                self._refs[key] = 0
                self._sizes[key] = size
                self.live_bytes += size
                self.peak_live_bytes = max(self.peak_live_bytes,
                                           self.live_bytes)
            self._refs[key] += 1
            weakref.finalize(o, self._drop, key)

    # -- the mode ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        # as FlopCounterMode: an op without a formula is counted by its
        # pieces where it decomposes
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        ins = [t for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)]
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        if name in _LIFT:
            return out
        if name in _COPIES and \
                {t.device for t in ins} != {t.device for t in outs}:
            return out
        self._follow(outs, ins)
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = 0
        if name not in _ALLOC and not _is_view(func):
            nbytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
            self.read.update(t.untyped_storage()._cdata for t in ins)
        trans = sum(t.numel() for t in outs) \
            if name in _TRANSCENDENTAL else 0
        row = self.rows.setdefault((name, self._site()), [0, 0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += trans
        return out

    # -- results ----------------------------------------------------------
    def records(self) -> list:
        """One dict per (op, call site), largest bytes first."""
        return [{"op": op, "site": site, "count": c, "flops": f,
                 "bytes": b, "transcendentals": t}
                for (op, site), (c, f, b, t) in
                sorted(self.rows.items(), key=lambda kv: -kv[1][2])]

    def totals(self) -> dict:
        return totals(self.records(), self.peak_live_bytes)


def totals(records, peak_live_bytes: int | None = None) -> dict:
    """The reference's ``aggregate`` dict over op records, plus the
    number of ops and (when known) the peak live bytes."""
    out = {"flops": float(sum(r["flops"] for r in records)),
           "bytes": float(sum(r["bytes"] for r in records)),
           "transcendentals": float(sum(r["transcendentals"]
                                        for r in records)),
           "collectives": {}, "collective_bytes": 0.0,
           "ops": sum(r["count"] for r in records)}
    if peak_live_bytes is not None:
        out["peak_live_bytes"] = int(peak_live_bytes)
    return out


def read_bytes(tensors, oc: OpCost) -> int:
    """The bytes of those of ``tensors`` (alive through ``oc``'s call, so
    no other storage took their place) whose storage a counted op read,
    each storage once."""
    seen = {}
    for t in tensors:
        key = t.untyped_storage()._cdata
        if key in oc.read:
            seen[key] = max(seen.get(key, 0), _nbytes(t))
    return sum(seen.values())


def count(fn, *args, **kw):
    """``(fn(*args, **kw), OpCost)``: the call's result and its counts."""
    with OpCost() as oc:
        out = fn(*args, **kw)
    return out, oc


def aggregate(fn, *args, **kw) -> dict:
    """The reference's ``hlo_cost.aggregate`` keys for one call of ``fn``:
    ``flops``, ``bytes``, ``transcendentals``, ``collectives`` (empty on
    one device) and ``collective_bytes``; also ``ops`` and
    ``peak_live_bytes``."""
    return count(fn, *args, **kw)[1].totals()
