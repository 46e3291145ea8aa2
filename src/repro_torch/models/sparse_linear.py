"""PackSELL sparse-weight linear layers (pruned-weight serving).

The port of ``repro.models.sparse_linear``: the paper's kernel in the LM
serving path. Decode is a memory-bound matvec, the regime the paper
targets, so a magnitude-pruned projection stored in PackSELL cuts the
bytes per decode step by (1 − density) × compression_ratio, with the
value codec (fp16 / bf16 / E8MY) choosing the accuracy/bandwidth point.

``PackSELLLinear`` is built offline from a dense weight and calls its
cached plan (``kernels.plan``): a 1-D input runs ``plan.spmv`` (K1 on the
card, over the fused stream), a batch runs ``plan.spmm`` (K3, one pass
over the words for every row of the batch). On the CPU the plan runs the
kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device
from ..core import packsell as pk
from ..kernels import plan as kplan

log = logging.getLogger(__name__)


def prune_magnitude(w: np.ndarray, density: float) -> np.ndarray:
    """Keep the top-``density`` fraction of |w| entries (global threshold).
    Returns the pruned dense weight (zeros elsewhere)."""
    if not (0.0 < density <= 1.0):
        raise ValueError(density)
    flat = np.abs(w).ravel()
    k = max(int(round(density * flat.size)), 1)
    if k >= flat.size:
        return w.copy()
    thresh = np.partition(flat, flat.size - k)[flat.size - k]
    out = np.where(np.abs(w) >= thresh, w, 0.0)
    return out


@dataclasses.dataclass
class PackSELLLinear:
    """y = W x with W pruned + stored as PackSELL ([out, in] row-major)."""

    mat: pk.PackSELLMatrix
    density: float
    dense_bytes: int
    # adaptive-precision provenance (codec="auto")
    precision_plan: object = None     # precision.select.PrecisionPlan | None
    fingerprint: str | None = None
    from_store: bool = False
    # retained pruned weight (CSR): the self-healing rebuild source
    # (serving warmup rebuilds unhealthy plans from it)
    _csr: object = None               # scipy.sparse.csr_matrix | None

    @classmethod
    def from_dense(cls, w: np.ndarray, *, density: float = 0.3,
                   codec: str = "bf16", D: int = 15, C: int = 128,
                   sigma: int = 256, error_budget: float = 1e-3,
                   store=None, device=None) -> "PackSELLLinear":
        """``w``: [in, out] dense kernel (the layout of ``layers.Dense``),
        on the host; stored transposed so rows = outputs, on ``device``
        (None: the GPU).

        ``codec="auto"`` hands the choice to the adaptive precision
        subsystem: ``repro_torch.precision`` selects the cheapest ``(codec,
        D)`` whose probe error fits ``error_budget`` on the pruned weight,
        with ``store`` (a ``precision.PrecisionStore`` or path) skipping
        re-analysis across restarts. The selection plan and matrix
        fingerprint are kept on the layer for serving-warmup logs.
        """
        from .. import precision as pr

        dev = _device.resolve_device(device)
        wp = prune_magnitude(np.asarray(w, np.float32), density)
        csr = sp.csr_matrix(wp.T)     # [out, in]
        pplan, from_store = None, False
        # fingerprint unconditionally: warmup restores (sb, wb) retile
        # winners for caller-fixed codecs too, not only codec="auto"
        fingerprint = pr.matrix_fingerprint(csr)
        if codec == "auto":
            if store is not None:
                store = pr.PrecisionStore.coerce(store)
                pplan, from_store = store.lookup_or_select(
                    csr, error_budget, sigma=sigma)
            else:
                pplan = pr.select_codec(csr, error_budget, sigma=sigma)
            prim = pplan.primary
            if prim.codec == "fp32":
                # no packed codec fits the budget; the best PackSELL can
                # store is E8M21, louder than the budget, so say so
                codec, D = "e8m", 1
                log.warning(
                    "PackSELLLinear codec='auto': no packed codec fits "
                    "error_budget=%.3g (selection says fp32); storing "
                    "e8m/D=1 (~2.4e-7 relative error) instead — the "
                    "budget is NOT met", error_budget)
            else:
                codec, D = prim.codec, prim.D
        mat = pk.from_csr(csr, C=C, sigma=sigma, D=D, codec=codec, device=dev)
        return cls(mat=mat, density=density,
                   dense_bytes=w.size * np.dtype(np.float32).itemsize,
                   precision_plan=pplan, fingerprint=fingerprint,
                   from_store=from_store, _csr=csr)

    @property
    def plan(self) -> kplan.SpMVPlan:
        """The cached SpMVPlan (built once, shared by every decode tick)."""
        return kplan.get_plan(self.mat)

    def rebuild(self) -> kplan.SpMVPlan:
        """Re-pack the matrix and plan from the retained pruned CSR: the
        recovery path when the guard layer marks the live plan unhealthy
        (a flipped bit in the packed operands survives every later
        dispatch, so only a fresh build clears it). Raises if the layer
        holds no retained CSR."""
        if self._csr is None:
            raise RuntimeError(
                "PackSELLLinear.rebuild: no retained CSR on this layer")
        self.mat = pk.from_csr(self._csr, C=self.mat.C, sigma=self.mat.sigma,
                               D=self.mat.D, codec=self.mat.codec_name,
                               device=self.mat.device)
        return kplan.get_plan(self.mat)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: [in] or [..., in] → [..., out], float32, through the cached
        plan. A batch is one SpMM over ``X = flat.T`` (``[in, rows]``, the
        layout K3 reads: the plan copies it once, ``rows × in`` floats); y
        comes back as the transposed view of the plan's ``[out, rows]``,
        with no copy."""
        plan = self.plan
        if x.dim() == 1:
            return plan.spmv(self.mat, x)
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        y = plan.spmm(self.mat, flat.T).T
        return y.reshape(*lead, -1)

    def warmup(self, batch: int = 0) -> kplan.SpMVPlan:
        """Build the plan and run the dispatch once (spmv; plus spmm at the
        given batch size) so the first serving tick pays nothing."""
        dev = self.mat.device
        self(torch.zeros((self.mat.m,), dtype=torch.float32, device=dev))
        if batch:
            self(torch.zeros((batch, self.mat.m), dtype=torch.float32,
                             device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self.plan

    def describe(self) -> dict:
        """Codec provenance for serving-warmup logs (DecodeEngine)."""
        return {
            "codec": self.mat.codec_name, "D": self.mat.D,
            "shape": [self.mat.n, self.mat.m], "density": self.density,
            "auto_selected": self.precision_plan is not None,
            # False only when selection fell back to fp32 but the layer
            # had to store a packed codec anyway (budget not certified)
            "budget_met": (self.precision_plan is None
                           or self.precision_plan.primary.codec
                           == self.mat.codec_name),
            "from_store": self.from_store, "fingerprint": self.fingerprint,
            "memory_ratio": self.memory_ratio(),
        }

    def memory_ratio(self) -> float:
        """Stored bytes vs the dense fp32 weight."""
        return self.mat.memory_stats()["packsell_bytes"] / self.dense_bytes

    def decode_bytes_per_token(self) -> int:
        """Bytes streamed per matvec (the decode-step cost)."""
        return self.mat.memory_stats()["packsell_bytes"]
