"""Slot-based decode engine: batched requests, continuous batching.

The port of ``repro.serving.engine`` (vLLM-style):

* A fixed pool of ``slots`` shares one cache: KV ``[L, slots, max_len,
  …]`` and, for the ssm and hybrid families, Mamba2's conv and SSM states
  ``[L, slots, …]``; the decode step runs every engine tick for the whole
  pool regardless of occupancy (inactive slots run too, and their results
  are dropped).
* Each prompt is prefilled eagerly at its exact length, with batch 1, and
  its cache rows are written into the pool at the assigned slot (the
  whole row of every key, conv and SSM states included, so the slot's
  previous request leaves nothing behind). New requests are admitted
  whenever a slot frees up (continuous batching).
* Sampling: greedy or temperature (an explicit ``torch.Generator`` from
  ``ServeConfig.seed``); per-slot EOS/max-token termination.

Where the reference jits the pool decode step once, the port captures it
once per engine into a CUDA graph (``solvers.graphs.Graph``, under its
``CAPTURE_LOCK``) over static buffers: the token buffer ``[slots, 1]``,
the cache, updated in place, and ``len``. A tick copies the last
tokens in and replays the graph; sampling runs outside it. The weights
are cast to the compute dtype once, when the engine is built
(``transformer.cast_params``), and not copied at all when they already
stand in it (``transformer.init_params(..., dtype=cfg.dtype)``). The moe,
ssm and hybrid families serve unchanged; a vlm config fails at its first
prefill with a ``KeyError`` on ``'patches'``, as the reference's does
(the engine prefills tokens only). An encdec config builds its pool
cache with ``enc_len`` 0, as the reference's: ``warmup()`` then raises
``ZeroDivisionError`` (cross-attention over no encoder position) and the
first prefill ``KeyError('frames')``; that family is served through
``forward_prefill``/``forward_decode``. Inside ``graphs.eager()`` a tick
runs the step's ops from the host instead, and on the CPU the graph runs
its body.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import _device
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..observe import metrics as _obs
from ..solvers import graphs

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4
    max_len: int = 512
    temperature: float = 0.0        # 0 => greedy
    eos_id: int = -1                # -1 => never stop on a token
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class WarmupSpec:
    """Everything :meth:`DecodeEngine.warmup` should prepare, in one place.

    * ``prompt_lens``: prefill prompt lengths to run once.
    * ``sparse_layers``: ``models.sparse_linear.PackSELLLinear`` layers:
      pre-builds their cached SpMV plans (and restores store retiles).
    * ``dist_plans``: ``repro_torch.distributed.DistSpMVPlan``\\ s to warm
      up (weight matrices split into shards).
    * ``composites``: any object with ``warmup(nb=...)``:
      ``kernels.composite.CompositePlan``, ``precision.MixedPackSELL``, …
    * ``precision_store``: a ``repro_torch.precision.PrecisionStore`` or
      path: restores kernel-autotune ``(sb, wb)`` retile winners into each
      layer's plan and logs auto-selected codecs.
    * ``nb``: multi-RHS width for plan/composite warmups (default: the
      engine's slot count).
    """

    prompt_lens: tuple = ()
    sparse_layers: tuple = ()
    dist_plans: tuple = ()
    composites: tuple = ()
    precision_store: object = None
    nb: Optional[int] = None


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # [len] int32
    max_new_tokens: int
    # filled by the engine:
    out_tokens: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class DecodeEngine:
    """The decode pool for ``params`` (a ``models.transformer.Transformer``)
    on ``device`` (None: the GPU)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = _device.resolve_device(device)
        self.params = tfm.cast_params(params, cfg.dtype, device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(scfg.seed)
        self.cache = tfm.init_cache(cfg, scfg.slots, scfg.max_len,
                                    device=self.device)
        # per-slot host state
        self.slot_req: list[Optional[Request]] = [None] * scfg.slots
        self.slot_remaining = np.zeros(scfg.slots, np.int64)
        self.last_token = np.zeros(scfg.slots, np.int32)
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self._uid = 0
        # the decode step's static token buffer and its graph
        self.tokens = torch.zeros((scfg.slots, 1), dtype=torch.int32,
                                  device=self.device)
        self._decode = graphs.Graph(graphs.method(self._decode_body),
                                    self.device)
        self._exporter = None

    # -- perf sentinel ---------------------------------------------------
    def metrics_endpoint_text(self) -> str:
        """The engine's metrics in Prometheus text exposition format,
        what a ``GET /metrics`` handler would return: serving counters
        (ticks, decode tokens, request latency quantiles) plus whatever
        else the flight recorder saw this process."""
        from ..observe import export as _export

        return _export.prometheus_text()

    def start_metrics_exporter(self, path: str = "artifacts/obs/serving.jsonl",
                               interval_s: float = 1.0):
        """Attach a background JSONL exporter (``observe.export``): one
        snapshot-delta record per interval, plus a flush after every
        :meth:`run` drain so short-lived engines still land their tallies.
        Idempotent per engine; returns the ``observe.export.Exporter``."""
        from ..observe import export as _export

        if self._exporter is None:
            meta = _export.run_meta(source="serving.engine",
                                    slots=self.scfg.slots,
                                    max_len=self.scfg.max_len)
            self._exporter = _export.start_exporter(
                interval_s=interval_s, path=path, meta=meta)
        return self._exporter

    def stop_metrics_exporter(self) -> None:
        """Stop the background exporter (final flush included)."""
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # however the with-block exits, the daemon flusher is stopped and
        # its last partial interval lands on disk
        self.stop_metrics_exporter()

    # ------------------------------------------------------------------
    def _decode_body(self) -> torch.Tensor:
        logits, _ = tfm.forward_decode(self.cfg, self.params, self.tokens,
                                       self.cache)
        return logits

    def state(self) -> dict:
        """A copy of the decode step's buffers (cache and token buffer)."""
        out = {k: v.clone() for k, v in self.cache.items()}
        out["tokens"] = self.tokens.clone()
        return out

    def set_state(self, saved: dict) -> None:
        """Write :meth:`state`'s copy back into the same buffers (the
        graph holds their addresses)."""
        for k, v in self.cache.items():
            v.copy_(saved[k])
        self.tokens.copy_(saved["tokens"])

    def warmup(self, spec: WarmupSpec | None = None, *, prompt_lens=(),
               sparse_layers=(), dist_plans=(), composites=(),
               precision_store=None) -> None:
        """Move set-up out of the serving hot path. Takes a
        :class:`WarmupSpec`, or the keyword arguments merged into one.

        Captures the pool decode step (its warm-up tick runs on the live
        buffers, which are restored after), runs a prefill at each given
        prompt length, pre-builds the cached SpMV plans of any PackSELL
        layers (rebuilding an unhealthy one, restoring store retiles),
        and warms distributed and composite plans at ``nb``; the first
        real tick then pays neither capture nor plan construction."""
        if spec is not None and not isinstance(spec, WarmupSpec):
            # historical positional call: warmup([16, 32]) meant prompt_lens
            if prompt_lens:
                raise ValueError("pass a WarmupSpec OR keyword arguments, "
                                 "not both")
            prompt_lens, spec = tuple(spec), None
        if spec is None:
            spec = WarmupSpec(prompt_lens=tuple(prompt_lens),
                              sparse_layers=tuple(sparse_layers),
                              dist_plans=tuple(dist_plans),
                              composites=tuple(composites),
                              precision_store=precision_store)
        elif (prompt_lens or sparse_layers or dist_plans or composites
              or precision_store is not None):
            raise ValueError("pass a WarmupSpec OR keyword arguments, "
                             "not both")
        store = spec.precision_store
        if store is not None:
            from ..precision import PrecisionStore
            store = PrecisionStore.coerce(store)
        nb = self.scfg.slots if spec.nb is None else int(spec.nb)
        saved = self.state()
        self.tokens.zero_()
        self._decode()
        self.set_state(saved)
        for plen in spec.prompt_lens:
            toks = torch.zeros((1, int(plen)), dtype=torch.int32,
                               device=self.device)
            tfm.forward_prefill(self.cfg, self.params, {"tokens": toks},
                                self.scfg.max_len)
        for i, lin in enumerate(spec.sparse_layers):
            self._warm_layer(i, lin, store)
        for dp in spec.dist_plans:
            dp.warmup(nb=nb)
        for comp in spec.composites:
            comp.warmup(nb=nb)
            if hasattr(comp, "describe"):
                log.info("warmup: composite %s", comp.describe())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_layer(self, i: int, lin, store) -> None:
        desc = lin.describe() if hasattr(lin, "describe") else {}
        # self-healing: a plan the guard layer marked unhealthy (checksum
        # trip, validation failure) is rebuilt from the layer's retained
        # CSR before any decode tick reuses it
        if hasattr(lin, "plan") and hasattr(lin, "rebuild"):
            from ..robust import guard as _guard
            health = _guard.plan_health(lin.plan)
            if health is not None:
                log.warning("warmup: layer %d plan unhealthy (%s) — "
                            "rebuilding from retained CSR", i, health)
                _obs.inc("serving.warmup_rebuild", reason=health)
                lin.rebuild()
        if store is not None and desc.get("fingerprint"):
            key = f"plan_{desc['codec']}{desc['D']}"
            layer_name = getattr(lin, "name", None) or f"layer_{i}"
            try:
                applied = store.apply_retile(desc["fingerprint"], key,
                                             lin.plan)
            except Exception as e:
                # a poisoned store entry (malformed tiles, infeasible band
                # retile) must not take warmup down: the layer keeps its
                # build-time tiles, which are always valid
                log.warning(
                    "warmup: %s (layer %d) retile from store FAILED — "
                    "shape=%s key=%s fingerprint=%s: %s", layer_name, i,
                    desc.get("shape"), key, desc["fingerprint"], e)
                _obs.inc("serving.warmup_retile_failure", key=key)
            else:
                if applied:
                    log.info("warmup: %s (layer %d) retiled from store "
                             "(%s)", layer_name, i, key)
        plan = lin.warmup()
        pdesc = plan.describe()
        plan_tag = "%s/%s" % (pdesc["variant"], pdesc["cache_mode"])
        if pdesc.get("fused"):
            plan_tag += "@wr=%d" % pdesc["ckpt_width"]
        if desc.get("auto_selected"):
            log.info("warmup: layer %d codec=%s D=%d auto-selected (%s), "
                     "memory_ratio=%.3f, plan=%s", i, desc["codec"],
                     desc["D"],
                     "store hit" if desc.get("from_store") else "analyzed",
                     desc.get("memory_ratio", float("nan")), plan_tag)
        elif desc:
            log.info("warmup: layer %d codec=%s D=%d (caller-fixed), "
                     "plan=%s", i, desc["codec"], desc["D"], plan_tag)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Request:
        req = Request(self._uid, np.asarray(prompt, np.int32),
                      max_new_tokens, t_submit=time.perf_counter())
        self._uid += 1
        self.queue.append(req)
        return req

    # ------------------------------------------------------------------
    @staticmethod
    def _insert_impl(pool_cache: dict, one_cache: dict, slot: int,
                     keys) -> None:
        """Write a B=1 prefill cache into pool slot ``slot``, in place:
        the whole ``[L, slot]`` row, zeros past the prompt included."""
        for k in keys:
            v = one_cache[k]
            if k == "len":
                pool_cache[k][slot:slot + 1].copy_(v[:1])
            else:
                # layer-major arrays: [L, B, ...] -> write batch row
                pool_cache[k][:, slot].copy_(v[:, 0])

    def _admit(self, req: Request):
        slot = self.slot_req.index(None)
        # prefill at the exact prompt length: padding-free, so positions,
        # causality, and the last-token logits are exact
        toks = torch.from_numpy(req.prompt[None, :]).to(self.device)
        logits, one_cache = tfm.forward_prefill(
            self.cfg, self.params, {"tokens": toks}, self.scfg.max_len)
        tok = self._sample(logits[:, -1])[0]
        req.t_first = time.perf_counter()
        req.out_tokens.append(int(tok))
        self._insert_impl(self.cache, one_cache, slot,
                          tuple(sorted(one_cache.keys())))
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new_tokens - 1
        self.last_token[slot] = int(tok)
        if self.slot_remaining[slot] <= 0 or int(tok) == self.scfg.eos_id:
            self._finish(slot)

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        req.t_done = time.perf_counter()
        self.done.append(req)
        self.slot_req[slot] = None
        self.slot_remaining[slot] = 0
        _obs.inc("serving.finished")
        _obs.observe("serving.request_latency_s", req.latency)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.to(torch.float32)
                              / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0].to(
            torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def tick(self) -> torch.Tensor:
        """The pool decode step on the last tokens: its logits ``[slots, 1,
        vocab_padded]``, the graph's output buffer (valid until the next
        tick). Advances every slot's cache."""
        self.tokens.copy_(torch.from_numpy(self.last_token[:, None]))
        return self._decode()

    def step(self) -> int:
        """One engine tick: admit to free slots, decode one token for all
        active slots. Returns the number of active slots."""
        while self.queue and None in self.slot_req:
            self._admit(self.queue.pop(0))
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        next_tok = self._sample(self.tick()[:, -1])
        for i in active:
            tok = int(next_tok[i])
            req = self.slot_req[i]
            req.out_tokens.append(tok)
            self.last_token[i] = tok
            self.slot_remaining[i] -= 1
            if self.slot_remaining[i] <= 0 or tok == self.scfg.eos_id:
                self._finish(i)
        _obs.inc("serving.tick")
        _obs.inc("serving.decode_tokens", len(active))
        return len(active)

    def run(self, max_ticks: int = 100_000) -> list[Request]:
        """Drain the queue; returns completed requests."""
        ticks = 0
        try:
            while (self.queue or any(r is not None for r in self.slot_req)) \
                    and ticks < max_ticks:
                self.step()
                ticks += 1
        finally:
            if self._exporter is not None:   # land this batch's tallies now
                self._exporter.sink.flush()  # even when a step raised
        return self.done

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        if not self.done:
            return {}
        lat = [r.latency for r in self.done]
        ttft = [r.ttft for r in self.done]
        ntok = sum(len(r.out_tokens) for r in self.done)
        span = max(r.t_done for r in self.done) - \
            min(r.t_submit for r in self.done)
        return {
            "requests": len(self.done),
            "tokens": ntok,
            "tokens_per_s": ntok / span if span > 0 else float("nan"),
            "mean_latency_s": float(np.mean(lat)),
            "mean_ttft_s": float(np.mean(ttft)),
        }
