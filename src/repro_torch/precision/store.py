"""On-disk autotune store for precision selections.

The port of ``repro.precision.store``, in the same file format, so one
store file serves both packages. A single JSON file maps a **matrix
fingerprint** (shape / nnz / value range / row-degree histogram / a
sample of the pattern and values, NOT the full contents; the reference's
string, bit for bit) to:

* ``precision``: the serialized
  :class:`~repro_torch.precision.select.PrecisionPlan` (with its
  machine-readable rationale), and
* ``retile``: ``(sb, wb[, wr])`` tile winners per plan key
  (``SpMVPlan.retile``), merged into the same entry so one lookup restores
  both decisions.

Writes are atomic (tmp file + ``os.replace``) under an advisory file lock,
entries another process wrote since our load are merged back in before a
save, and an unreadable file is quarantined (``*.corrupt``) instead of
taking selection down.

Retile winners are stored under a device-qualified key, ``<key>@cuda`` or
``<key>@cpu``: the reference qualifies them by ``jax.default_backend()``;
the port by the device of the plan they are applied to.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..observe import metrics as _obs
from . import analyze as an
from . import select as se

try:
    import fcntl
except ImportError:  # non-POSIX: locking degrades to a no-op
    fcntl = None


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory cross-process lock on ``path + '.lock'`` (flock): two
    processes autotuning against one store serialize their
    read-modify-write cycles instead of losing each other's entries.
    No-op where fcntl is unavailable."""
    if fcntl is None:
        yield
        return
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    lockpath = path + ".lock"
    with open(lockpath, "w") as lf:
        fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf.fileno(), fcntl.LOCK_UN)


def matrix_fingerprint(a: sp.csr_matrix) -> str:
    """Stable content fingerprint of a CSR matrix (hex, 16 chars)."""
    a = a.tocsr()
    a.sort_indices()
    h = hashlib.sha256()
    n, m = a.shape
    row_nnz = np.diff(a.indptr)
    # log2-binned row-degree histogram: shape of the sparsity structure
    hist = np.bincount(
        np.clip(np.log2(np.maximum(row_nnz, 1)).astype(np.int64), 0, 31),
        minlength=32)
    data = np.abs(a.data.astype(np.float64))
    nzmin = float(data[data > 0].min()) if np.any(data > 0) else 0.0
    stats = (n, m, int(a.nnz), float(data.max(initial=0.0)), nzmin,
             float(a.data.astype(np.float64).sum()))
    h.update(repr(stats).encode())
    h.update(hist.tobytes())
    # deterministic sample of the pattern + values
    step = max(1, a.nnz // 1024)
    h.update(np.ascontiguousarray(a.indices[::step]).tobytes())
    h.update(np.ascontiguousarray(
        a.data[::step].astype(np.float32)).tobytes())
    return h.hexdigest()[:16]


class PrecisionStore:
    """A JSON file of fingerprint → {precision, retile} entries."""

    VERSION = 1

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._entries: dict = {}
        self.load()

    @classmethod
    def coerce(cls, store_or_path) -> "PrecisionStore":
        """Accept an existing store or a path to one (the ``store=``
        argument every integration point takes)."""
        if isinstance(store_or_path, cls):
            return store_or_path
        return cls(store_or_path)

    # -- persistence -------------------------------------------------------
    def _quarantine(self, why: str) -> dict:
        """Move an unreadable store aside (``*.corrupt``) and start fresh;
        the quarantined copy is kept for post-mortems."""
        quarantine = self.path + ".corrupt"
        try:
            os.replace(self.path, quarantine)
        except OSError:
            quarantine = "<could not move>"
        warnings.warn(
            f"precision store {self.path} is unreadable ({why}); "
            f"quarantined to {quarantine}, starting with an empty store",
            RuntimeWarning, stacklevel=4)
        _obs.inc("store.quarantine")
        return {}

    def _read_entries(self) -> dict:
        if not os.path.exists(self.path):
            return {}
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            return self._quarantine(str(e))
        if not isinstance(blob, dict) \
                or not isinstance(blob.get("entries", {}), dict):
            return self._quarantine("top-level JSON is not a store object")
        if blob.get("version", 1) != self.VERSION:
            raise ValueError(
                f"precision store {self.path} has version "
                f"{blob.get('version')}, expected {self.VERSION}")
        return blob.get("entries", {})

    def load(self) -> None:
        with _file_lock(self.path):
            self._entries = self._read_entries()

    def save(self) -> None:
        """Atomic write (tmp file + ``os.replace``) under the advisory
        ``*.lock`` file. Disk entries another process added since our load
        are merged back in first (ours win per key)."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        with _file_lock(self.path):
            for fp, ent in self._read_entries().items():
                mine = self._entries.setdefault(fp, {})
                for k, v in ent.items():
                    if k == "retile" and isinstance(mine.get(k), dict):
                        for rk, rv in v.items():
                            mine[k].setdefault(rk, rv)
                    else:
                        mine.setdefault(k, v)
            blob = {"version": self.VERSION, "entries": self._entries}
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(blob, f, indent=1, default=float)
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

    # -- precision plans ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._entries

    def get_plan(self, fingerprint: str,
                 mode: str = "global") -> se.PrecisionPlan | None:
        ent = self._entries.get(fingerprint)
        key = "precision" if mode == "global" else f"precision:{mode}"
        if ent is None or key not in ent:
            return None
        return se.PrecisionPlan.from_dict(ent[key])

    def put_plan(self, plan: se.PrecisionPlan, *,
                 fingerprint: str | None = None, save: bool = True) -> str:
        fp = fingerprint or plan.fingerprint
        if not fp:
            raise ValueError("need a fingerprint (plan.fingerprint unset)")
        key = ("precision" if plan.mode == "global"
               else f"precision:{plan.mode}")
        self._entries.setdefault(fp, {})[key] = plan.to_dict()
        if save:
            self.save()
        return fp

    def lookup_or_select(self, a: sp.csr_matrix, error_budget: float, *,
                         validate: bool = False, save: bool = True,
                         **select_kw):
        """``(plan, from_store)``: the stored selection when the
        fingerprint hits (optionally re-validating its probe guarantee on
        the actual matrix), else a fresh
        :func:`~repro_torch.precision.select.select_codec` run, persisted.

        A stored plan counts as a hit only when it covers the request: the
        same ``mode``, a budget and safety at least as tight as asked, and,
        when the caller restricts ``candidates``, every stored class inside
        them."""
        fp = matrix_fingerprint(a)
        mode = select_kw.get("mode", "global")
        safety = select_kw.get("safety", 0.5)
        plan = self.get_plan(fp, mode=mode)
        if plan is not None and "candidates" in select_kw:
            allowed = {tuple(c) for c in select_kw["candidates"]}
            allowed.add(("fp32", 0))     # the fallback is always legal
            if not all((c.codec, c.D) in allowed for c in plan.classes):
                plan = None              # stored plan uses excluded codecs
        if plan is not None and plan.primary.codec == "fp32":
            # a fallback plan certifies "nothing packed fits plan.budget",
            # which transfers to TIGHTER requests only
            budget_ok = error_budget <= plan.error_budget
        elif plan is not None:
            budget_ok = plan.error_budget <= error_budget
        else:
            budget_ok = False
        if (plan is not None and budget_ok
                and plan.rationale.get("safety", 1.0) <= safety):
            if not validate:
                _obs.inc("store.lookup", outcome="hit", mode=mode)
                return plan, True
            c = plan.primary
            err = (0.0 if c.codec == "fp32" else an.probe_error(
                a, c.codec, c.D,
                n_probes=select_kw.get("n_probes", 3),
                seed=select_kw.get("seed", 0) + 1))
            if err <= error_budget:
                _obs.inc("store.lookup", outcome="hit", mode=mode)
                return plan, True
            # stale entry (fingerprint collision / matrix drift): reselect
        _obs.inc("store.lookup", outcome="miss", mode=mode)
        plan = se.select_codec(a, error_budget, fingerprint=fp, **select_kw)
        self.put_plan(plan, fingerprint=fp, save=save)
        return plan, False

    # -- retile winners ----------------------------------------------------
    @staticmethod
    def _backend(backend) -> str:
        """The device qualifier of retile keys: ``backend`` as given (a
        string or a ``torch.device``, whose type is used), else the device
        the port's entry points default to (``cuda`` when there is one,
        else ``cpu``)."""
        if backend is None:
            return "cuda" if torch.cuda.is_available() else "cpu"
        if isinstance(backend, torch.device):
            return backend.type
        return str(backend)

    def put_retile(self, fingerprint: str, key: str, tiles, *,
                   backend=None, save: bool = True) -> None:
        """Record ``(sb, wb)`` or ``(sb, wb, wr)`` winners under a plan key
        (e.g. ``'plan_e8m8'``), qualified by device (``'<key>@cuda'``):
        winners tuned on one device are never applied to a plan on
        another."""
        bk = self._backend(backend)
        ent = self._entries.setdefault(fingerprint, {})
        ent.setdefault("retile", {})[f"{key}@{bk}"] = [
            [int(v) for v in t] for t in tiles]
        if save:
            self.save()

    def get_retile(self, fingerprint: str, key: str, *, backend=None):
        """Device-qualified lookup; legacy unqualified entries (written
        before winners were keyed per device) still resolve when no
        qualified entry shadows them."""
        ent = self._entries.get(fingerprint, {})
        retile = ent.get("retile", {})
        tiles = retile.get(f"{key}@{self._backend(backend)}")
        if tiles is None:
            tiles = retile.get(key)      # legacy un-keyed entry
        return None if tiles is None else [tuple(t) for t in tiles]

    def apply_retile(self, fingerprint: str, key: str, plan, *,
                     backend=None) -> bool:
        """Install stored tile winners into an
        :class:`~repro_torch.kernels.plan.SpMVPlan` (looked up under the
        plan's own device unless ``backend`` says otherwise); True when
        applied."""
        tiles = self.get_retile(fingerprint, key,
                                backend=plan.device if backend is None
                                else backend)
        if tiles is None or len(tiles) != len(plan.tiles):
            _obs.inc("store.retile", applied="no")
            return False
        plan.retile(tiles)
        _obs.inc("store.retile", applied="yes")
        return True


# ---------------------------------------------------------------------------
# Per-shard selection (host only; the dist_auto kind)
# ---------------------------------------------------------------------------


def shard_fingerprints(a: sp.csr_matrix, n_shards: int) -> list[str]:
    """Per-row-shard content fingerprints (the distributed layer's store
    key), over the partitioner's balanced contiguous row blocks."""
    from ..distributed.partition import partition_rows

    a = a.tocsr()
    part = partition_rows(a.shape[0], n_shards)
    return [matrix_fingerprint(a[slice(*part.rows_of(p))])
            for p in range(n_shards)]


def select_codec_per_shard(a: sp.csr_matrix, n_shards: int,
                           error_budget: float, *, store=None,
                           **select_kw):
    """Global-mode codec selection run per row shard (fingerprint + store
    lookup per shard), coalesced to ONE fleet-wide class: distinct
    per-shard picks are tried most accurate first (smallest a-priori ulp
    bound) and the fleet takes the first whose measured probe error fits
    ``safety × budget`` on EVERY shard; else fp32. Each shard's selection
    is still recorded in ``store``.

    Returns ``(per_shard_plans, fleet_class)``."""
    from ..distributed.partition import partition_rows

    a = a.tocsr()
    part = partition_rows(a.shape[0], n_shards)
    fps = shard_fingerprints(a, n_shards)
    store = None if store is None else PrecisionStore.coerce(store)
    plans, subs = [], []
    for p in range(n_shards):
        sub = a[slice(*part.rows_of(p))]
        if sub.shape[0] == 0:
            plans.append(None)        # empty shard: no constraint
            continue
        subs.append(sub)
        if store is not None:
            plan, _ = store.lookup_or_select(sub, error_budget, **select_kw)
        else:
            plan = se.select_codec(sub, error_budget, fingerprint=fps[p],
                                   **select_kw)
        plans.append(plan)

    threshold = select_kw.get("safety", 0.5) * error_budget
    n_probes = select_kw.get("n_probes", 3)
    seed = select_kw.get("seed", 0)
    picks = {(pl.primary.codec, pl.primary.D)
             for pl in plans if pl is not None}
    # one probe context per shard, shared across candidate certifications
    ctxs = [an._probe_context(sub, n_probes, seed + 1) for sub in subs]
    fleet = se.PrecisionClass(*se.FP32_CLASS)
    for codec, D in sorted(picks, key=lambda cd_: an.ulp_bound(*cd_)):
        if codec == "fp32":
            break                     # a shard fell back: fleet must too
        if all(an.probe_error(sub, codec, D, n_probes=n_probes,
                              seed=seed + 1, _ctx=ctx) <= threshold
               for sub, ctx in zip(subs, ctxs)):
            fleet = se.PrecisionClass(codec, D)   # rows=None
            break
    return plans, fleet
