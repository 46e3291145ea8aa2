"""The model axis: tensor-parallel training, prefill and decode over
``"model"`` for the six families, one model shard per rank (or all of
them in one process, the stacked form), held to the stacked form bit for
bit.

The reference lays its layers out with GSPMD constraints
(``repro.parallel.sharding.constrain``; ``_sp`` in its ``_apply_block``,
``_score_shard_dim``, the experts over ``"model"``, Mamba2's specs). The
port writes the same layout as explicit exchanges over the mesh's
per-shard lists (``launch.mesh``: :func:`~..launch.mesh.gather_seq`,
:func:`~..launch.mesh.scatter_seq`, :func:`~..launch.mesh.model_sum`):

* **The residual stream is sequence-sharded** ``[B, S/M, d]`` over the M
  model shards (the reference's ``P(("pod", "data"), "model", None)``):
  norms run on a shard's rows; each column-parallel product reads the
  rows gathered whole, and each row-parallel product's partial sums are
  reduce-scattered back to the rows in rank order.
* **Attention** takes ``_score_shard_dim``'s rule (:func:`attention_rule`):
  the KV heads where M divides them, else the GQA groups (every shard
  holds all of ``wk``/``wv``), else the query rows (``"qc"``: every shard
  holds the whole attention, computes q, k and v of its rows and gathers
  K and V whole; no reduce-scatter follows, its rows' outputs are whole).
* **MLP**: ``wi``/``wg`` column-, ``wo`` row-parallel over ``d_ff``.
* **MoE**: each shard holds ``Ep/M`` of the padded experts and routes the
  whole row (the capacity is per row over all S tokens, so the row is
  gathered first): every shard runs ``moe.route`` on the same tokens, so
  the kept set is the one-device kept set. Each shard sums the gated
  outputs of its experts' assignments in float32 and the partial sums are
  reduce-scattered in rank order: with ``top_k <= 2`` that is the
  one-device combine's bits (a sum of two terms and zeros), with more a
  reordering of a float32 sum of ``top_k`` terms. The shared experts are
  column/row-parallel as an MLP. The aux terms are the same on every
  shard; model index 0 alone takes their gradient. The load-balance
  term's means run over the tokens of every data shard (an all-reduce
  over ``"dp"``), as over the reference's global batch; under the pod
  wire over the data shards of one pod (``batch_axis="data"``), as the
  reference's step, manual over ``"pod"``, sees one pod's batch.
* **Mamba2**: shard r computes its heads: ``z``, ``x`` and ``dt`` of its
  head range and ``B``/``C`` whole (one group), so its part of ``in_proj``
  is that index set of columns (not a contiguous slice: the reference's
  ``P(None, "model")`` cuts the packed columns where heads do not lie),
  ``conv_w``/``conv_b`` the same rule, ``A_log``, ``D``, ``dt_bias`` by head,
  ``norm_g`` and ``out_proj`` by its channels. The gated norm's mean runs
  over all of ``d_inner``: its sum of squares is a rank-order sum across
  the shards. ``B``/``C``'s columns are held by every shard and their
  gradients are partial.
* **Embedding, head and CE** over the vocabulary: the table (tied or not)
  and the head are split on the vocab rows/columns (the reference splits
  the embedding on ``d``; one vocab split serves both uses of a tied
  table, and a lookup is exact: one shard's row and zeros, summed by the
  reduce-scatter into the sequence shards). CE runs vocab-parallel per
  chunk of the gathered rows: each shard's ``V/M`` columns of the float32
  logits, the max and the sum of exponentials across the shards in rank
  order, the label's logit from the shard that owns it. No shard makes
  the ``[B, S, V]`` logits.
* Norm gains, the router, the projector and every leaf M does not divide
  (the reference's ``sanitize_spec``) are held whole by every shard; a
  sublayer whose leaves are whole runs on a shard's rows (an MLP), or on
  the gathered rows, keeping its own (Mamba2, the stubs' projectors).

**Gradients.** A leaf every shard holds gets a partial gradient on each
(its rows', its heads', its experts'); the step sums them over the model
shards in rank order. A value every shard computes alike and that feeds
the loss alike (the CE's sums, the aux terms) is differentiated once: its
all-reduce's backward is the identity, or only model index 0 takes the
gradient.

**Layout.** A shard's part of a parameter is the index set its compute
needs along one dim (:class:`Part`): ranges only it holds (``own``) and
ranges every shard holds (``shared``); its state holds the two as
separate tensors (pieces), each a ZeRO leaf of its own
(:func:`zero_layout`: the reference's ZeRO dim over the data-parallel
shards within it; ``own`` gradients sum over the data shards of one model
index, ``shared`` over every shard). The master, m and v on disk keep the
reference's whole leaves (:func:`checkpoint_leaves`, :func:`restore`), so
a checkpoint crosses mesh shapes and packages.

**Serving** (:func:`forward_prefill`, :func:`forward_decode`,
:func:`next_tokens`; ``launch.steps.make_prefill_step`` and
``make_decode_step`` on a mesh). The pieces are the same index sets in
the serving dtypes (:func:`serve_pieces`: ``transformer.cast_params``'
rule, no master). The prefill is the training forward's layers without
recompute or backward; it returns each shard's float32 logits of the last
position over its vocabulary columns (the reference's out spec
``P(("pod", "data"), None, "model")``) and its cache. The decode's
residual ``[b, 1, d]`` is whole on every model shard of a data shard:
column-parallel products read it, row-parallel partial sums are summed in
rank order (``model_sum``, where training reduce-scatters), and the next
token is the largest logit across the shards, ties to the lowest index.

Rules the port does not copy, on purpose:

* **The cache over the model shards** (:func:`cache_shapes`). The
  reference's ``cache_spec_tree`` splits K/V (``ek``/``ev`` too) on the KV
  heads where 16 divides them, else on the head dim. Under ``"kv"`` the
  port splits the heads as well. Under ``"g"`` and ``"qc"`` it splits the
  **positions** into M contiguous ranges of ``max_len`` (of ``enc_len``
  for ``ek``/``ev``): the reference's own score never splits the head dim
  (``repro/models/attention.py``), so a head-dim split would exchange
  partial scores over every position; a position split holds the same
  bytes a device and exchanges one ``(acc, max, sum)`` state,
  ``[b, H, hd + 2]`` float32, per attention layer and token, merged in
  rank order (``attention.merge_partials``). The prefill's K/V of every
  position are on every shard under both rules (``"qc"`` gathers them,
  ``"g"`` computes them whole), so each shard keeps its range with no
  exchange, whatever the prompt's length. A decode step writes a row's new
  K/V on the shard whose range holds its ``len``; rows advance apart.
* **Mamba2's conv window** holds the shard's index set of the conv's
  channels: ``x``'s channels of its heads and ``B``/``C``'s whole (the
  ``conv_w`` rule), where the reference splits the packed channels
  evenly; the SSM state holds the shard's heads, as the reference's.
* **The decode's sums**: ``wo``, the MLP's and shared experts' ``wo``,
  the experts' float32 combine, ``out_proj`` and the gated norm's sum of
  squares are each a rank-order sum over the model shards (GSPMD picks
  its own reduction); under ``"qc"`` ``wo`` is whole and not summed.
"""
from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.nn.functional as F

from ..launch import mesh as lm
from . import attention as attn
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import transformer as tfm

def attention_rule(cfg, M: int) -> str:
    """``"kv"`` where M divides the KV heads, else ``"g"`` where it divides
    the GQA groups, else ``"qc"`` (the query rows)."""
    KV = cfg.n_kv_heads
    G = cfg.n_heads // max(KV, 1)
    if KV and KV % M == 0:
        return "kv"
    if G and G % M == 0:
        return "g"
    return "qc"


@dataclasses.dataclass(frozen=True)
class Part:
    """How the model shards hold parameter ``name`` (whole shape
    ``shape``): along ``dim``, shard r alone holds the ranges ``own[r]``
    and every shard the ranges ``shared`` (``(lo, hi)`` pairs)."""

    name: str
    shape: tuple
    dim: int
    own: tuple
    shared: tuple

    def _segments(self, r: int) -> list:
        """Shard r's ranges in index order: ``(kind, offset in its piece,
        length)``."""
        segs, off = [], {"own": 0, "shared": 0}
        for kind, ranges in (("own", self.own[r]), ("shared", self.shared)):
            for lo, hi in ranges:
                segs.append((lo, kind, off[kind], hi - lo))
                off[kind] += hi - lo
        return [s[1:] for s in sorted(segs)]

    def piece_shape(self, kind: str) -> tuple | None:
        n = sum(hi - lo for lo, hi in (self.own[0] if kind == "own"
                                       else self.shared))
        if n == 0:
            return None
        s = list(self.shape)
        s[self.dim] = n
        return tuple(s)

    def take(self, whole: torch.Tensor, r: int, kind: str, lead: int = 0):
        """Shard r's ``kind`` piece of ``whole`` (a new tensor; ``lead``
        leading dims before the parameter's, a stacked leaf's layers)."""
        ranges = self.own[r] if kind == "own" else self.shared
        d = self.dim + lead
        return torch.cat([whole.narrow(d, lo, hi - lo) for lo, hi in ranges],
                         d)

    def compute(self, pieces: dict, r: int) -> torch.Tensor:
        """Shard r's compute tensor from its pieces (``{"own", "shared"}``):
        its ranges in index order."""
        segs = self._segments(r)
        if len(segs) == 1:
            return pieces[segs[0][0]]
        return torch.cat([pieces[k].narrow(self.dim, o, n)
                          for k, o, n in segs], self.dim)

    def assemble(self, owns: list, shared) -> torch.Tensor:
        """The whole parameter from every shard's own piece (``owns``, in
        model order) and the shared one, along ``dim + lead`` where the
        pieces carry ``lead`` leading dims (a stacked leaf's layers)."""
        lead = (owns[0] if owns[0] is not None else shared).dim() \
            - len(self.shape)
        d = self.dim + lead
        parts = []
        for r, piece in enumerate(owns):
            off = 0
            for lo, hi in self.own[r]:
                parts.append((lo, piece.narrow(d, off, hi - lo)))
                off += hi - lo
        off = 0
        for lo, hi in self.shared:
            parts.append((lo, shared.narrow(d, off, hi - lo)))
            off += hi - lo
        return torch.cat([t for _, t in sorted(parts, key=lambda x: x[0])],
                         d)


def _even(lo: int, n: int, M: int, r: int) -> tuple:
    return ((lo + r * n // M, lo + (r + 1) * n // M),)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The model axis's choices for ``cfg`` at ``M`` shards: the attention
    rule and which sublayers split (the others' leaves are whole on every
    shard)."""

    M: int
    rule: str
    mlp: bool           # d_ff: the MLPs and the shared experts
    experts: bool
    ssm: bool
    vocab: bool


def make_plan(cfg, M: int) -> Plan:
    ff = cfg.d_ff
    return Plan(M, attention_rule(cfg, M) if cfg.n_heads else "qc",
                bool(ff) and ff % M == 0,
                moe_mod.padded_experts(cfg.n_experts or 1) % M == 0,
                bool(cfg.ssm_state) and cfg.ssm_heads % M == 0,
                cfg.vocab_padded % M == 0)


def _part(cfg, plan: Plan, name: str, shape: tuple) -> Part:
    """The :class:`Part` of parameter ``name`` (module docstring)."""
    M = plan.M
    keys = name.split(".")
    leaf, mod = keys[-1], keys[-2] if len(keys) > 1 else ""

    def whole(dim=0):
        return Part(name, shape, dim, ((),) * M, ((0, shape[dim]),))

    def split(dim, per_rank, shared=()):
        return Part(name, shape, dim, tuple(per_rank(r) for r in range(M)),
                    tuple(shared))

    if leaf == "g" or leaf == "router" or keys[0] == "projector":
        return whole()
    if mod in ("wq", "wk", "wv", "wo") and keys[-3] in ("attn", "xattn"):
        if plan.rule == "qc":
            return whole()
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        G = H // KV

        def q_heads(r):
            if plan.rule == "kv":
                return _even(0, H * hd, M, r)
            return tuple((kv * G * hd + r * (G // M) * hd,
                          kv * G * hd + (r + 1) * (G // M) * hd)
                         for kv in range(KV))

        dim = 0 if (mod == "wo" or leaf == "b") else 1
        if mod in ("wq", "wo"):
            return split(dim, q_heads)
        if plan.rule == "g":
            return whole(dim)
        return split(dim, lambda r: _even(0, KV * hd, M, r))
    if len(keys) >= 3 and keys[-3] == "mlp":
        if not plan.mlp:
            return whole()
        return split(0 if mod == "wo" else 1,
                     lambda r: _even(0, cfg.d_ff, M, r))
    if mod == "experts":
        if not plan.experts:
            return whole()
        return split(0, lambda r: _even(0, shape[0], M, r))
    if mod == "shared" and len(keys) >= 3 and keys[-3] == "moe":
        if not plan.mlp:
            return whole()
        return split(1 if leaf == "wo" else 2,
                     lambda r: _even(0, cfg.d_ff, M, r))
    if mod == "ssm":
        if not plan.ssm:
            return whole()
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        if leaf == "in_proj":
            return split(1, lambda r: _even(0, di, M, r) + _even(di, di, M, r)
                         + _even(2 * di + 2 * N, H, M, r),
                         ((2 * di, 2 * di + 2 * N),))
        if leaf in ("conv_w", "conv_b"):
            return split(1 if leaf == "conv_w" else 0,
                         lambda r: _even(0, di, M, r), ((di, di + 2 * N),))
        if leaf in ("A_log", "D", "dt_bias"):
            return split(0, lambda r: _even(0, H, M, r))
        return split(0, lambda r: _even(0, di, M, r))  # norm_g, out_proj
    if keys[0] == "embed" and plan.vocab:
        return split(0, lambda r: _even(0, cfg.vocab_padded, M, r))
    if keys[0] == "head" and plan.vocab:
        return split(1, lambda r: _even(0, cfg.vocab_padded, M, r))
    return whole()


class Layout:
    """Every parameter's :class:`Part` for ``cfg`` at ``M`` model shards,
    in ``Transformer.parameters()`` order, and the flat list of pieces a
    shard holds (:attr:`pieces`: ``(parameter index, kind)``; own before
    shared, the same list for every shard)."""

    def __init__(self, cfg, M: int):
        self.cfg, self.M = cfg, M
        self.plan = make_plan(cfg, M)
        self.meta = tfm.Transformer(cfg, dtype=torch.float32, device="meta")
        named = list(self.meta.named_parameters())
        self.names = [n for n, _ in named]
        self.parts = [_part(cfg, self.plan, n, tuple(p.shape))
                      for n, p in named]
        self.pieces, self.piece_of = [], {}
        for i, part in enumerate(self.parts):
            for kind in ("own", "shared"):
                if part.piece_shape(kind) is not None:
                    self.piece_of[(i, kind)] = len(self.pieces)
                    self.pieces.append((i, kind))
        self.index = {n: i for i, n in enumerate(self.names)}

    def piece_shapes(self) -> list:
        return [self.parts[i].piece_shape(k) for i, k in self.pieces]

    def take(self, params: list, r: int) -> list:
        """Shard r's pieces of the whole parameters ``params``
        (``parameters()`` order)."""
        return [self.parts[i].take(params[i], r, k) for i, k in self.pieces]

    def param(self, pieces: list, i: int, r: int) -> torch.Tensor:
        """Shard r's compute tensor of parameter ``i`` from its pieces."""
        got = {k: pieces[self.piece_of[(i, k)]] for k in ("own", "shared")
               if (i, k) in self.piece_of}
        return self.parts[i].compute(got, r)

    def view(self, pieces: list, r: int, prefix: str, module, dt):
        """The namespace tree of ``module`` (a part of :attr:`meta` named
        ``prefix``) with shard r's compute tensors cast to ``dt``, as
        ``transformer._cast_block`` gives the whole ones (None: as the
        pieces hold them, the serving dtypes)."""
        ns = types.SimpleNamespace(**tfm._absent(module))
        for name, p in module._parameters.items():
            if p is None:
                setattr(ns, name, None)
                continue
            t = self.param(pieces, self.index[prefix + name], r)
            setattr(ns, name, t if dt is None else t.to(dt))
        for name, c in module._modules.items():
            setattr(ns, name, None if c is None else self.view(
                pieces, r, f"{prefix}{name}.", c, dt))
        return ns


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ctx:
    cfg: object
    mesh: object
    layout: Layout
    ranks: list          # the model index of each shard held
    dt: torch.dtype
    #: the shards whose tokens make the batch of the MoE aux terms' means
    batch_axis: str = "dp"
    #: the serving forward: the pieces hold the serving dtypes
    #: (:func:`serve_pieces`) and are read as they are
    serve: bool = False

    @property
    def M(self) -> int:
        return self.layout.M

    @property
    def param_dt(self):
        """The dtype a view casts the pieces to (None: not cast)."""
        return None if self.serve else self.dt

    @property
    def plan(self) -> Plan:
        return self.layout.plan


def _own_rows(ctx, xs: list, dim: int = 1) -> list:
    """Each held shard's rows of whole ``xs[s]`` along ``dim``."""
    return [x.narrow(dim, r * (x.shape[dim] // ctx.M), x.shape[dim] // ctx.M)
            for x, r in zip(xs, ctx.ranks)]


def _norm(ps, xs, ctx):
    return [L.rmsnorm_apply(p, x, ctx.cfg.norm_eps, ctx.dt)
            for p, x in zip(ps, xs)]


def attention(ctx, ps, ns, pos, *, causal: bool, enc=None,
              keep: bool = False):
    """Self-attention of the normed rows ``ns`` (``[B, S/M, d]`` per shard;
    ``pos``: ``[B, S]`` positions of the whole rows), or with ``enc``
    (``[B, Se, d]`` per shard, whole) the cross-attention over it, no
    RoPE. Returns each shard's rows of the output (module docstring);
    with ``keep`` also each shard's ``(k, v)`` over every position: its
    KV heads under ``"kv"``, all of them under ``"g"`` and ``"qc"``."""
    cfg = ctx.cfg
    hd = cfg.head_dim
    if ctx.plan.rule == "qc":
        own_pos = _own_rows(ctx, [pos] * len(ns))
        qs, ks, vs = [], [], []
        for p, x, po in zip(ps, ns, own_pos):
            B, S, _ = x.shape
            if enc is None:
                xq, xk, xv = lm.fanout(x, 3)
                src = (xk, xv)
            else:
                xq, src = x, (enc[len(qs)],) * 2
            q = L.dense_apply(p.wq, xq, ctx.dt).reshape(B, S, -1, hd)
            Sk = src[0].shape[1]
            k = L.dense_apply(p.wk, src[0], ctx.dt).reshape(B, Sk, -1, hd)
            v = L.dense_apply(p.wv, src[1], ctx.dt).reshape(B, Sk, -1, hd)
            if enc is None:
                q, k = L.rope(q, k, po, cfg.rope_theta)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        if enc is None:
            ks, vs = lm.gather_seq(ctx.mesh, ks), lm.gather_seq(ctx.mesh, vs)
        outs = []
        for p, q, k, v, r in zip(ps, qs, ks, vs, ctx.ranks):
            B, S = q.shape[:2]
            o = attn.flash_attention(q, k, v, causal=causal, q_offset=r * S,
                                     skip_offset=r * S)
            outs.append(L.dense_apply(p.wo, o.reshape(B, S, -1), ctx.dt))
        return (outs, list(zip(ks, vs))) if keep else outs
    full = lm.gather_seq(ctx.mesh, ns)
    outs, kvs = [], []
    for p, x in zip(ps, full):
        B, S, _ = x.shape
        if enc is None:
            xq, xk, xv = lm.fanout(x, 3)
        else:
            xq = x
            xk = xv = enc[len(outs)]
        Sk = xk.shape[1]
        q = L.dense_apply(p.wq, xq, ctx.dt).reshape(B, S, -1, hd)
        k = L.dense_apply(p.wk, xk, ctx.dt).reshape(B, Sk, -1, hd)
        v = L.dense_apply(p.wv, xv, ctx.dt).reshape(B, Sk, -1, hd)
        if enc is None:
            q, k = L.rope(q, k, pos, cfg.rope_theta)
        o = attn.flash_attention(q, k, v, causal=causal)
        outs.append(L.dense_apply(p.wo, o.reshape(B, S, -1), ctx.dt))
        kvs.append((k, v))
    outs = lm.scatter_seq(ctx.mesh, outs)
    return (outs, kvs) if keep else outs


def mlp(ctx, ps, zs) -> list:
    """SwiGLU: column/row-parallel over ``d_ff``, or on each shard's rows
    where its leaves are whole."""
    if not ctx.plan.mlp:
        return [L.swiglu_apply(p, z, ctx.dt) for p, z in zip(ps, zs)]
    full = lm.gather_seq(ctx.mesh, zs)
    return lm.scatter_seq(ctx.mesh, [L.swiglu_apply(p, x, ctx.dt)
                                     for p, x in zip(ps, full)])


def moe(ctx, ps, zs, *, aux: bool = True) -> tuple:
    """The MoE layer (module docstring): each shard's rows of the output,
    and each shard's aux terms (the same values on every shard; None
    without ``aux``, as the serving paths drop them)."""
    dt = ctx.dt
    full = lm.gather_seq(ctx.mesh, zs)
    ys, shs, routes = _moe_partials(ctx, ps, full)
    auxes = _aux(ctx, routes) if aux else None
    if ctx.plan.experts:
        ys = lm.scatter_seq(ctx.mesh, ys)
    else:
        ys = _own_rows(ctx, ys)
    ys = [y.to(dt) for y in ys]
    if shs:
        shs = (lm.scatter_seq(ctx.mesh, shs) if ctx.plan.mlp
               else _own_rows(ctx, shs))
        ys = [y + s for y, s in zip(ys, shs)]
    return ys, auxes


def _moe_partials(ctx, ps, full) -> tuple:
    """Each shard's float32 sum of its experts' gated outputs over the
    whole rows ``full`` (``[B, S, d]``; every shard routes them alike),
    its shared experts' partial sums (``[]`` without them) and its
    routing."""
    cfg, dt, M = ctx.cfg, ctx.dt, ctx.M
    B = full[0].shape[0]
    Ep, k = moe_mod.padded_experts(cfg.n_experts), cfg.top_k
    Ep_r = Ep // M if ctx.plan.experts else Ep
    ys, shs, auxes = [], [], []
    for p, x, r in zip(ps, full, ctx.ranks):
        S, d = x.shape[1], x.shape[2]
        A = S * k
        xr, xd, xsh = lm.fanout(x, 3)
        rt = moe_mod.route(p, cfg, xr)
        cap = rt.cap
        lo = r * Ep_r * cap if ctx.plan.experts else 0
        local = rt.slot - lo
        mine = rt.keep & (local >= 0) & (local < Ep_r * cap)
        slot = torch.where(mine, local, Ep_r * cap)
        xs = xd.to(dt).unsqueeze(2).expand(B, S, k, d).reshape(B, A, d)
        buf = torch.zeros((B, Ep_r * cap + 1, d), dtype=dt, device=x.device)
        buf.scatter_(1, slot.unsqueeze(-1).expand(B, A, d), xs)
        buf = buf[:, :Ep_r * cap].unflatten(1, (Ep_r, cap))
        out = moe_mod._swiglu(p.experts, buf, dt, "becd,edf->becf",
                              "becf,efd->becd").reshape(B, Ep_r * cap, d)
        picked = torch.gather(out, 1, torch.clamp_max(
            slot, Ep_r * cap - 1).unsqueeze(-1).expand(B, A, d)).to(
                torch.float32)
        contrib = torch.where(mine.unsqueeze(-1),
                              picked * rt.gates.reshape(B, A, 1), 0.0)
        ys.append(contrib.view(B, S, k, d).sum(dim=2))
        if p.shared is not None:
            s = moe_mod._swiglu(p.shared, xsh.reshape(B * S, d).to(dt), dt,
                                "td,ndf->ntf", "ntf,nfd->ntd")
            shs.append(s.sum(dim=0).reshape(B, S, d))
        auxes.append(rt)
    return ys, shs, auxes


def _aux(ctx, routes: list) -> list:
    """``moe_lb`` and ``moe_z`` of each held shard's routing (``moe.
    aux_losses``), the load-balance term's two means over the tokens of
    every data shard (the reference's global batch; ``ctx.batch_axis``):
    each shard's means summed over those shards in rank order, over their
    count."""
    cfg = ctx.cfg
    E = cfg.n_experts
    f32 = torch.float32
    stats = []
    for rt in routes:
        n = rt.experts.numel()
        me = rt.probs.reshape(-1, E).mean(dim=0)
        ce = torch.zeros(E, dtype=f32, device=me.device).scatter_add_(
            0, rt.experts.reshape(-1),
            torch.full((n,), 1.0 / n, dtype=f32, device=me.device))
        stats.append(torch.stack([me, ce]))
    P = ctx.mesh.axis_size(ctx.batch_axis)
    if P > 1:
        stats = [s / P for s in lm.model_sum(ctx.mesh, stats,
                                             axis=ctx.batch_axis)]
    return [{"moe_lb": (E * torch.sum(s[0] * s[1])).to(f32),
             "moe_z": torch.mean(torch.logsumexp(rt.logits, dim=-1) ** 2)
             .to(f32)} for s, rt in zip(stats, routes)]


def mamba(ctx, ps, xs, *, state: bool = False):
    """Mamba2 over the gathered rows, each shard its heads (module
    docstring); each shard's rows of the output, and with ``state`` each
    shard's final ``(conv, ssm)`` states of its channels and heads (the
    prefill's; ``ssm._final_state``'s formula)."""
    cfg, dt = ctx.cfg, ctx.dt
    full = lm.gather_seq(ctx.mesh, xs)
    if not ctx.plan.ssm:
        got = [ssm_mod.apply_full(p, cfg, x, dt, state=state)
               for p, x in zip(ps, full)]
        rows = _own_rows(ctx, [y for y, _ in got])
        if not state:
            return rows
        return rows, [(st["conv"], st["ssm"]) for _, st in got]
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32
    ys, zs, sqs, states = [], [], [], []
    for p, x in zip(ps, full):
        B, S, _ = x.shape
        H_r = p.A_log.shape[0]
        di_r = H_r * Pd
        zxbcdt = x.to(dt) @ p.in_proj.to(dt)
        z = zxbcdt[..., :di_r]
        xbc = zxbcdt[..., di_r:2 * di_r + 2 * N]
        dt_raw = zxbcdt[..., 2 * di_r + 2 * N:]
        xbc, conv = ssm_mod._causal_conv(xbc, p.conv_w.to(dt),
                                         p.conv_b.to(dt))
        xh = xbc[..., :di_r].reshape(B, S, H_r, Pd).to(f32)
        Bc, Cc = xbc[..., di_r:di_r + N], xbc[..., di_r + N:]
        dts = ssm_mod.softplus(dt_raw.to(f32) + p.dt_bias)
        A = -torch.exp(p.A_log)
        y = ssm_mod._ssd_chunked(cfg, xh, dts, Bc.to(f32), Cc.to(f32), A)
        if state:
            states.append((conv, ssm_mod._final_state(cfg, xh, dts,
                                                      Bc.to(f32), A)))
        y = y + xh * p.D[None, None, :, None]
        yz = (y.reshape(B, S, di_r).to(dt) * F.silu(z)).to(f32)
        ys.append(yz)
        sqs.append(torch.sum(yz * yz, dim=-1, keepdim=True))
    tot = lm.model_sum(ctx.mesh, sqs)
    outs = []
    for p, yf, t in zip(ps, ys, tot):
        rs = torch.rsqrt(t / cfg.d_inner + cfg.norm_eps)
        y = (yf * rs).to(dt) * p.norm_g.to(dt)
        outs.append(y @ p.out_proj.to(dt))
    rows = lm.scatter_seq(ctx.mesh, outs)
    return (rows, states) if state else rows


def block(ctx, bps, xs, pos, *, causal=True, enc=None):
    """One attention block on each shard's rows: self-attention, the
    cross-attention over ``enc`` where given, then the MLP or MoE. Returns
    (rows, aux per shard or None)."""
    h = attention(ctx, [b.attn for b in bps],
                  _norm([b.ln1 for b in bps], xs, ctx), pos, causal=causal)
    xs = [x + a for x, a in zip(xs, h)]
    if enc is not None:
        h = attention(ctx, [b.xattn for b in bps],
                      _norm([b.ln3 for b in bps], xs, ctx), pos,
                      causal=False, enc=enc)
        xs = [x + a for x, a in zip(xs, h)]
    zs = _norm([b.ln2 for b in bps], xs, ctx)
    if bps[0].moe is not None:
        m, aux = moe(ctx, [b.moe for b in bps], zs)
    else:
        m, aux = mlp(ctx, [b.mlp for b in bps], zs), None
    return [x + a for x, a in zip(xs, m)], aux


def _views(ctx, pieces, prefix, module):
    return [ctx.layout.view(p, r, prefix, module, ctx.param_dt)
            for p, r in zip(pieces, ctx.ranks)]


#: the parts of the model outside the layer lists
_TOPS = ("embed", "lnf", "head", "shared", "enc_lnf", "projector")


def _tops(ctx, pieces) -> list:
    """Each held shard's views of :data:`_TOPS`."""
    meta = ctx.layout.meta
    return [types.SimpleNamespace(**{
        name: None if getattr(meta, name) is None else ctx.layout.view(
            p, r, name + ".", getattr(meta, name), ctx.param_dt)
        for name in _TOPS}) for p, r in zip(pieces, ctx.ranks)]


def _embed(ctx, tops, tokens):
    """The token rows of each shard's partial embedding (vocab split: its
    rows of the table and zeros), ``[B, S, d]``; a whole table's rows."""
    out = []
    for t, tok, r in zip(tops, tokens, ctx.ranks):
        if not ctx.plan.vocab:
            out.append(L.embed_apply(t.embed, tok, ctx.dt))
            continue
        w = t.embed.w
        Vr, V = w.shape[0], ctx.cfg.vocab_padded
        idx = tok.reshape(-1)
        idx = torch.where(idx < 0, idx + V, idx)
        loc = idx - r * Vr
        mine = (loc >= 0) & (loc < Vr)
        rows = F.embedding(loc.clamp(0, Vr - 1), w)
        rows = torch.where(mine[:, None], rows, 0.0)
        if r == 0:
            bad = (idx < 0) | (idx >= V)
            rows = torch.where(bad[:, None], float("nan"), rows)
        out.append(rows.reshape(*tok.shape, -1).to(ctx.dt))
    return out


def _to_rows(ctx, xs):
    """Whole-sequence partials (vocab split) or wholes to each shard's
    rows."""
    return lm.scatter_seq(ctx.mesh, xs) if ctx.plan.vocab \
        else _own_rows(ctx, xs)


def _embedded(ctx, tops, batches) -> tuple:
    """Each shard's rows of the embedded input and the whole positions
    (the vision stub's patches first)."""
    cfg, dt = ctx.cfg, ctx.dt
    toks = [b["tokens"] for b in batches]
    xs = _embed(ctx, tops, toks)
    B = toks[0].shape[0]
    dev = toks[0].device
    if cfg.frontend == "vision_stub":
        out = []
        for t, b, x, r in zip(tops, batches, xs, ctx.ranks):
            if r == 0 or not ctx.plan.vocab:
                proj = L.dense_apply(t.projector,
                                     b["patches"].to(dt), dt)
            else:
                proj = torch.zeros(b["patches"].shape[:2] + (x.shape[-1],),
                                   dtype=dt, device=dev)
            out.append(torch.cat([proj, x], dim=1))
        xs = out
    S = xs[0].shape[1]
    if S % ctx.M:
        raise ValueError(f"a sequence of {S} over {ctx.M} model shards: the "
                         "residual stream is split into equal rows")
    pos = torch.arange(S, device=dev)[None, :].expand(B, S)
    return _to_rows(ctx, xs), pos


def _inputs(ctx, tops, batches):
    """Each shard's rows of the embedded input, the whole positions,
    labels and mask (the vision stub's patches first)."""
    xs, pos = _embedded(ctx, tops, batches)
    labels = [b["labels"] for b in batches]
    masks = [b["mask"].to(torch.float32) for b in batches]
    if ctx.cfg.frontend == "vision_stub":
        B, P = batches[0]["patches"].shape[:2]
        dev = pos.device
        zl = torch.zeros((B, P), dtype=labels[0].dtype, device=dev)
        zm = torch.zeros((B, P), dtype=torch.float32, device=dev)
        labels = [torch.cat([zl, lab], 1) for lab in labels]
        masks = [torch.cat([zm, m], 1) for m in masks]
    return xs, pos, labels, masks


def _ce(ctx, tops, xs, labels, masks, chunk: int = 512) -> list:
    """Each shard's summed CE over the whole batch (module docstring; the
    same value on every model shard), in chunks of the gathered rows,
    each recomputed in the backward."""
    cfg = ctx.cfg
    heads = [t.head.w if t.head is not None else t.embed.w.T for t in tops]
    if not ctx.plan.vocab:
        out = []
        for h, x, lab, m in zip(heads, xs, _own_rows(ctx, labels),
                                _own_rows(ctx, masks)):
            out.append(tfm.chunked_ce_loss(cfg, h, x, lab, m)[0])
        return lm.model_sum(ctx.mesh, out, replicated=True)
    full = lm.gather_seq(ctx.mesh, xs)
    B, S, _ = full[0].shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xc, lc, mc, hc = [], [], [], []
    for x, lab, m, h in zip(full, labels, masks, heads):
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            lab = F.pad(lab, (0, pad))
            m = F.pad(m, (0, pad))
        xc.append(x.split(chunk, dim=1))
        lc.append(lab.split(chunk, dim=1))
        mc.append(m.split(chunk, dim=1))
        hc.append(lm.fanout(h, nc) if nc > 1 else (h,))
    n = len(full)
    totals = [torch.zeros((), dtype=torch.float32, device=full[0].device)
              for _ in range(n)]
    for c in range(nc):
        labs = [lc[i][c] for i in range(n)]
        msks = [mc[i][c] for i in range(n)]

        def one(*args, labs=labs, msks=msks):
            return tuple(_ce_chunk(ctx, list(args[:n]), list(args[n:]), labs,
                                   msks))

        got = tfm._remat(one, *[xc[i][c] for i in range(n)],
                         *[hc[i][c] for i in range(n)])
        totals = [t + g for t, g in zip(totals, got)]
    return totals


def _ce_chunk(ctx, xs, heads, labs, msks) -> list:
    """One chunk of the vocab-parallel CE on every shard held."""
    cfg = ctx.cfg
    f32 = torch.float32
    logits, owns = [], []
    for x, h, r in zip(xs, heads, ctx.ranks):
        lg = (x @ h.to(x.dtype)).to(f32)
        Vr = h.shape[-1]
        cols = r * Vr + torch.arange(Vr, device=lg.device)
        if cfg.vocab_padded > cfg.vocab:
            lg = torch.where(cols < cfg.vocab, lg, -1e30)
        logits.append(lg)
        owns.append(r * Vr)
    gmax = lm.model_max(ctx.mesh, [lg.amax(dim=-1) for lg in logits])
    sums, lls = [], []
    for lg, mx, lab, lo in zip(logits, gmax, labs, owns):
        sums.append(torch.sum(torch.exp(lg - mx[..., None]), dim=-1))
        loc = lab.long() - lo
        mine = (loc >= 0) & (loc < lg.shape[-1])
        ll = torch.gather(lg, -1, loc.clamp(0, lg.shape[-1] - 1)[..., None])
        lls.append(torch.where(mine, ll[..., 0], 0.0))
    sums = lm.model_sum(ctx.mesh, sums, replicated=True)
    lls = lm.model_sum(ctx.mesh, lls, replicated=True)
    return [torch.sum((mx + torch.log(s) - ll) * m)
            for mx, s, ll, m in zip(gmax, sums, lls, msks)]


def _encode(ctx, tops, pieces, batches):
    """The encoder on each shard's rows of the frames: the audio stub's
    projector (whole), then the encoder blocks, then ``enc_lnf``."""
    cfg, dt = ctx.cfg, ctx.dt
    hs = [L.dense_apply(t.projector, b["frames"].to(dt), dt)
          for t, b in zip(tops, batches)]
    B, Se, _ = hs[0].shape
    if Se % ctx.M:
        raise ValueError(f"{Se} frames over {ctx.M} model shards")
    hs = _own_rows(ctx, hs)
    pos = torch.arange(Se, device=hs[0].device)[None, :].expand(B, Se)
    for i, b in enumerate(ctx.layout.meta.enc_blocks):
        def layer(*xs, i=i, b=b):
            bps = _views(ctx, pieces, f"enc_blocks.{i}.", b)
            return tuple(block(ctx, bps, list(xs), pos, causal=False)[0])

        hs = list(tfm._remat(layer, *hs))
    return _norm([t.enc_lnf for t in tops], hs, ctx)


def forward_train(ctx, pieces: list, batches: list) -> list:
    """The training loss of each shard held (the reference's
    ``forward_train``; the same value on every model shard of a data
    shard). ``pieces``: each held shard's parameter pieces
    (:attr:`Layout.pieces`); ``batches``: each held shard's batch."""
    cfg = ctx.cfg
    meta = ctx.layout.meta
    tops = _tops(ctx, pieces)
    n = len(pieces)
    zero = [torch.zeros((), dtype=torch.float32, device=ctx.mesh.device)
            for _ in range(n)]
    lb, zz = list(zero), list(zero)
    if cfg.family == "encdec":
        enc = _encode(ctx, tops, pieces, batches)
        encs = lm.gather_seq(ctx.mesh, enc)
        nl = cfg.n_layers
        uses = [lm.fanout(e, nl) if nl > 1 else (e,) for e in encs]
        xs, pos, labels, masks = _inputs(ctx, tops, batches)
        for i, b in enumerate(meta.blocks):
            def layer(*args, i=i, b=b):
                bps = _views(ctx, pieces, f"blocks.{i}.", b)
                return tuple(block(ctx, bps, list(args[:n]), pos,
                                   enc=list(args[n:]))[0])

            xs = list(tfm._remat(layer, *xs, *[u[i] for u in uses]))
    else:
        xs, pos, labels, masks = _inputs(ctx, tops, batches)
        shared = [t.shared for t in tops]
        for i, b in enumerate(meta.blocks):
            def layer(*xs, i=i, b=b):
                bps = _views(ctx, pieces, f"blocks.{i}.", b)
                xs = list(xs)
                if cfg.family in ("ssm", "hybrid"):
                    h = mamba(ctx, [bp.ssm for bp in bps],
                              _norm([bp.ln1 for bp in bps], xs, ctx))
                    xs = [x + a for x, a in zip(xs, h)]
                    if shared[0] is not None and tfm._uses_shared(cfg, i):
                        xs = block(ctx, shared, xs, pos)[0]
                    return tuple(xs)
                xs, aux = block(ctx, bps, xs, pos)
                if aux is None:
                    return tuple(xs)
                return tuple(xs) + tuple(a["moe_lb"] for a in aux) + tuple(
                    a["moe_z"] for a in aux)

            out = tfm._remat(layer, *xs)
            xs = list(out[:n])
            if len(out) > n:
                lb = [a + g for a, g in zip(lb, out[n:2 * n])]
                zz = [a + g for a, g in zip(zz, out[2 * n:])]
    xs = _norm([t.lnf for t in tops], xs, ctx)
    totals = _ce(ctx, tops, xs, labels, masks)
    out = []
    for tot, m, a, z, r in zip(totals, masks, lb, zz, ctx.ranks):
        if r:
            # the same value; the gradient taken once, on model index 0
            a, z = a.detach() + 0.0 * a, z.detach() + 0.0 * z
        loss = tot / torch.clamp_min(m.sum(), 1.0)
        out.append(loss + 0.01 * a + 0.001 * z)
    return out


def make_ctx(cfg, mesh, layout: Layout | None = None, *,
             batch_axis: str = "dp", serve: bool = False) -> _Ctx:
    layout = Layout(cfg, mesh.model) if layout is None else layout
    return _Ctx(cfg, mesh, layout, [mesh.model_index(s) for s in mesh.local],
                L.as_dtype(cfg.dtype), batch_axis, serve)


def value_and_grad(ctx, pieces: list, batches: list):
    """(each held shard's loss, each held shard's float32 gradients of its
    pieces); a piece the loss does not reach gets zeros."""
    losses = forward_train(ctx, pieces, batches)
    flat = [p for ps in pieces for p in ps]
    grads = torch.autograd.grad(losses, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    k = len(pieces[0])
    return ([l.detach() for l in losses],
            [grads[i * k:(i + 1) * k] for i in range(len(pieces))])


def grads_of(ctx, pieces, batches, microbatch: int | None = None):
    """:func:`value_and_grad` of each shard's batch, or the exact mean over
    its slices of ``microbatch`` rows (``launch.steps.grads_of``)."""
    if microbatch is None:
        return value_and_grad(ctx, pieces, batches)
    n_micro = batches[0]["tokens"].shape[0] // microbatch
    loss_sum = gsum = None
    for i in range(n_micro):
        sl = slice(i * microbatch, (i + 1) * microbatch)
        losses, grads = value_and_grad(
            ctx, pieces, [{k: v[sl] for k, v in b.items()} for b in batches])
        if loss_sum is None:
            loss_sum, gsum = losses, grads
            continue
        loss_sum = [a + b for a, b in zip(loss_sum, losses)]
        gsum = [[a + g for a, g in zip(x, y)] for x, y in zip(gsum, grads)]
    return ([l / n_micro for l in loss_sum],
            [[g / n_micro for g in x] for x in gsum])


# ---------------------------------------------------------------------------
# serving: the prefill and decode over the model shards
# ---------------------------------------------------------------------------


def serve_pieces(layout: Layout, params, ranks) -> list:
    """The pieces of model indices ``ranks`` (a list, one per shard held)
    of the one-device ``params`` (a ``Transformer``), where they lie, in
    the serving dtypes of ``transformer.cast_params``: the compute dtype,
    the router and Mamba2's ``A_log``, ``D`` and ``dt_bias`` float32 (no
    master: the reference's prefill and decode read ``cfg.dtype``)."""
    params = tfm.cast_params(params, layout.cfg.dtype)
    whole = [p.detach() for p in params.parameters()]
    return [[x.contiguous() for x in layout.take(whole, r)] for r in ranks]


def _span(ctx, n: int, what: str) -> int:
    """The positions of ``n`` one model shard holds under ``"g"``/``"qc"``
    (module docstring)."""
    if n % ctx.M:
        raise ValueError(f"{what} of {n} positions over {ctx.M} model "
                         "shards: each holds an equal range")
    return n // ctx.M


def cache_shapes(ctx, batch: int, max_len: int, enc_len: int = 0) -> dict:
    """``{name: (shape, dtype)}`` of one shard's cache, the keys of
    ``transformer.init_cache`` in its order (module docstring's layout):
    ``k``/``v`` (``ek``/``ev``) ``[L, B, max_len, KV/M, hd]`` under
    ``"kv"``, else ``[L, B, max_len/M, KV, hd]``; ``conv`` ``[L, B, K-1,
    di/M + 2N]`` and ``ssm`` ``[L, B, H/M, N, P]`` where M divides the
    heads (else whole); ``len`` ``[B]``."""
    cfg, M = ctx.cfg, ctx.M
    dt, i32, f32 = ctx.dt, torch.int32, torch.float32
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def kv(n, what):
        if ctx.plan.rule == "kv":
            return (batch, n, KV // M, hd)
        return (batch, _span(ctx, n, what), KV, hd)

    out = {}
    na = tfm.n_attn_caches(cfg)
    if na:
        out["k"] = out["v"] = ((na,) + kv(max_len, "a cache"), dt)
        out["len"] = ((batch,), i32)
    if cfg.family in ("ssm", "hybrid"):
        split = M if ctx.plan.ssm else 1
        ch = cfg.d_inner // split + 2 * cfg.ssm_state
        nl = cfg.n_layers
        out["conv"] = ((nl, batch, cfg.ssm_conv - 1, ch), dt)
        out["ssm"] = ((nl, batch, cfg.ssm_heads // split, cfg.ssm_state,
                       cfg.ssm_head_dim), f32)
        if cfg.family == "ssm":
            out["len"] = ((batch,), i32)
    if cfg.family == "encdec":
        out["ek"] = out["ev"] = ((cfg.n_layers,) + kv(enc_len,
                                                       "an encoder cache"), dt)
    return out


def init_caches(ctx, batch: int, max_len: int, enc_len: int = 0) -> list:
    """Each held shard's zeroed cache (:func:`cache_shapes`) on the mesh's
    device."""
    shapes = cache_shapes(ctx, batch, max_len, enc_len)
    dev = ctx.mesh.device
    return [{k: torch.zeros(s, dtype=t, device=dev)
             for k, (s, t) in shapes.items()} for _ in ctx.ranks]


def _put_kv(ctx, caches, names, i: int, kvs: list) -> None:
    """Layer ``i``'s K/V of every position (:func:`attention`'s ``keep``)
    into each shard's cache ``names`` (``("k", "v")`` or ``("ek",
    "ev")``): its heads under ``"kv"``, else its range of positions."""
    for c, kv, r in zip(caches, kvs, ctx.ranks):
        for name, t in zip(names, kv):
            dst = c[name][i]
            if ctx.plan.rule == "kv":
                dst[:, :t.shape[1]] = t
                continue
            span = dst.shape[1]
            lo, hi = r * span, min(t.shape[1], (r + 1) * span)
            if hi > lo:
                dst[:, :hi - lo] = t[:, lo:hi]


def _serve_block(ctx, bps, xs, pos, enc=None) -> tuple:
    """One attention block of the prefill on each shard's rows (the
    training :func:`block` without the aux terms): ``(rows, (k, v) per
    shard, (ek, ev) per shard or None)``."""
    h, kvs = attention(ctx, [b.attn for b in bps],
                       _norm([b.ln1 for b in bps], xs, ctx), pos,
                       causal=True, keep=True)
    xs = [x + a for x, a in zip(xs, h)]
    ekvs = None
    if enc is not None:
        h, ekvs = attention(ctx, [b.xattn for b in bps],
                            _norm([b.ln3 for b in bps], xs, ctx), pos,
                            causal=False, enc=enc, keep=True)
        xs = [x + a for x, a in zip(xs, h)]
    zs = _norm([b.ln2 for b in bps], xs, ctx)
    if bps[0].moe is not None:
        m, _ = moe(ctx, [b.moe for b in bps], zs, aux=False)
    else:
        m = mlp(ctx, [b.mlp for b in bps], zs)
    return [x + a for x, a in zip(xs, m)], kvs, ekvs


def _head(ctx, tops, xs) -> list:
    """Each shard's float32 logits of ``xs`` (``[B, 1, d]``, normed) over
    its vocabulary columns (all of them where M does not divide the
    vocabulary), the padded columns at -1e30."""
    cfg = ctx.cfg
    out = []
    for t, x, r in zip(tops, xs, ctx.ranks):
        h = t.head.w if t.head is not None else t.embed.w.T
        lg = (x @ h.to(x.dtype)).to(torch.float32)
        Vr = h.shape[-1]
        if cfg.vocab_padded > cfg.vocab:
            lo = r * Vr if ctx.plan.vocab else 0
            cols = lo + torch.arange(Vr, device=lg.device)
            lg = torch.where(cols < cfg.vocab, lg, -1e30)
        out.append(lg)
    return out


@torch.no_grad()
def forward_prefill(ctx, pieces: list, batches: list, max_len: int) -> tuple:
    """The prompt of each held shard's batch (its data shard's rows; the
    vision stub's ``patches``, the encoder's ``frames``) through the
    tensor-parallel layers of the training forward (module docstring), no
    recompute, no backward: ``(logits, caches)``, each shard's float32
    logits of the last position over its vocabulary columns ``[B, 1,
    V/M]`` (the reference's out sharding) and its cache
    (:func:`cache_shapes`), ``len`` at the prompt's length. The hybrid's
    shared block runs after layer ``i`` where ``i % attn_every ==
    attn_every - 1``, its K/V in cache ``i // attn_every``."""
    cfg = ctx.cfg
    meta = ctx.layout.meta
    tops = _tops(ctx, pieces)
    B = batches[0]["tokens"].shape[0]
    encs = None
    if cfg.family == "encdec":
        encs = lm.gather_seq(ctx.mesh, _encode(ctx, tops, pieces, batches))
    xs, pos = _embedded(ctx, tops, batches)
    S = pos.shape[1]
    if S > max_len:
        raise ValueError(f"a prompt of {S} positions in a cache of {max_len}")
    caches = init_caches(ctx, B, max_len,
                         0 if encs is None else encs[0].shape[1])
    for i, b in enumerate(meta.blocks):
        bps = _views(ctx, pieces, f"blocks.{i}.", b)
        if b.ssm is None:
            xs, kvs, ekvs = _serve_block(ctx, bps, xs, pos, encs)
            _put_kv(ctx, caches, ("k", "v"), i, kvs)
            if ekvs is not None:
                _put_kv(ctx, caches, ("ek", "ev"), i, ekvs)
            continue
        h, states = mamba(ctx, [bp.ssm for bp in bps],
                          _norm([bp.ln1 for bp in bps], xs, ctx), state=True)
        xs = [x + a for x, a in zip(xs, h)]
        for c, (conv, st) in zip(caches, states):
            c["conv"][i] = conv
            c["ssm"][i] = st
        if tfm._uses_shared(cfg, i):
            xs, kvs, _ = _serve_block(ctx, [t.shared for t in tops], xs, pos)
            _put_kv(ctx, caches, ("k", "v"), i // cfg.attn_every, kvs)
    xs = _norm([t.lnf for t in tops], xs, ctx)
    # the last position lies in the last model shard's rows
    last = ctx.mesh.all_gather("model", [x[:, -1:].contiguous() for x in xs])
    logits = _head(ctx, tops, [g[-1] for g in last])
    for c in caches:
        c["len"].fill_(S)
    return logits, caches


def _row_sum(ctx, xs: list) -> list:
    """The row-parallel products' partial sums of the decode, summed over
    the model shards in rank order (``launch.mesh.model_sum``)."""
    return lm.model_sum(ctx.mesh, xs)


def _decode_attention(ctx, ps, ns, kvs, lens) -> list:
    """One token's attention (``ns``: ``[b, 1, d]`` per shard, whole) over
    each shard's cache ``kvs`` (``(k, v)`` of one layer), written in place
    at ``lens`` (None: the cross-attention over ``ek``/``ev``, no RoPE, no
    write, every position valid). Under ``"kv"`` each shard's heads over
    its cache heads, then ``wo``'s rank-order sum; else every shard's
    query heads (gathered under ``"g"``) over its positions, the partial
    states merged in rank order (``attention.merge_partials``), then
    ``wo`` (whole under ``"qc"``: no sum)."""
    cfg, dt, hd, rule = ctx.cfg, ctx.dt, ctx.cfg.head_dim, ctx.plan.rule
    lens = lens if lens is not None else [None] * len(ns)
    qs, news = [], []
    for p, x, ln in zip(ps, ns, lens):
        B = x.shape[0]
        q = L.dense_apply(p.wq, x, dt).reshape(B, 1, -1, hd)
        if ln is not None:
            k = L.dense_apply(p.wk, x, dt).reshape(B, 1, -1, hd)
            v = L.dense_apply(p.wv, x, dt).reshape(B, 1, -1, hd)
            q, k = L.rope(q, k, ln[:, None], cfg.rope_theta)
            news.append((k, v))
        qs.append(q)
    if rule == "kv":
        outs = []
        for p, q, (ck, cv), ln, new in zip(ps, qs, kvs, lens,
                                           news or [None] * len(qs)):
            B = q.shape[0]
            if ln is None:
                o = attn.flash_attention(q, ck, cv, causal=False)
            else:
                attn.write_kv(ck, new[0], ln)
                attn.write_kv(cv, new[1], ln)
                o = attn.flash_attention(q, ck.to(dt), cv.to(dt),
                                         causal=False, kv_len=ln + 1,
                                         q_chunk=1, kv_chunk=4096)
            outs.append(L.dense_apply(p.wo, o.reshape(B, 1, -1), dt))
        return _row_sum(ctx, outs)
    if rule == "g":
        # each shard's query heads, G/M of every GQA group: whole heads
        M, KV = ctx.M, cfg.n_kv_heads
        got = ctx.mesh.all_gather("model", [q.contiguous() for q in qs])
        qs = [g.unflatten(3, (KV, -1)).permute(1, 2, 3, 0, 4, 5).reshape(
            g.shape[1], 1, -1, hd) for g in got]
    states = []
    for q, (ck, cv), ln, new, r in zip(qs, kvs, lens,
                                       news or [None] * len(qs), ctx.ranks):
        span = ck.shape[1]
        lo = r * span
        if ln is None:
            m, s, acc = attn.flash_attention(q, ck, cv, causal=False,
                                             partial=True)
        else:
            attn.write_kv(ck, new[0], ln, offset=lo)
            attn.write_kv(cv, new[1], ln, offset=lo)
            m, s, acc = attn.flash_attention(
                q, ck.to(dt), cv.to(dt), causal=False,
                kv_len=torch.clamp(ln + 1 - lo, 0, span), q_chunk=1,
                kv_chunk=4096, partial=True)
        states.append(torch.cat([acc, m[..., None], s[..., None]], dim=-1))
    got = ctx.mesh.all_gather("model", states)
    outs = []
    for p, g, r in zip(ps, got, ctx.ranks):
        o = attn.merge_partials(g).to(dt)
        B = o.shape[0]
        if rule == "g":
            # this shard's heads: G/M of every group, in index order
            o = o.unflatten(2, (cfg.n_kv_heads, ctx.M, -1))[:, :, :, r]
        outs.append(L.dense_apply(p.wo, o.reshape(B, 1, -1), dt))
    return outs if rule == "qc" else _row_sum(ctx, outs)


def _decode_moe(ctx, ps, zs) -> list:
    """The MoE layer on one token a row, whole on every shard: every shard
    routes it, sums its experts' gated outputs, and the shards' float32
    partials are summed in rank order (the shared experts as an MLP)."""
    ys, shs, _ = _moe_partials(ctx, ps, zs)
    if ctx.plan.experts:
        ys = _row_sum(ctx, ys)
    ys = [y.to(ctx.dt) for y in ys]
    if shs:
        if ctx.plan.mlp:
            shs = _row_sum(ctx, shs)
        ys = [y + s for y, s in zip(ys, shs)]
    return ys


def _decode_block(ctx, bps, xs, caches, ai: int) -> list:
    """One attention block of the decode (cache index ``ai``)."""
    lens = [c["len"] for c in caches]
    h = _decode_attention(ctx, [b.attn for b in bps],
                          _norm([b.ln1 for b in bps], xs, ctx),
                          [(c["k"][ai], c["v"][ai]) for c in caches], lens)
    xs = [x + a for x, a in zip(xs, h)]
    if bps[0].xattn is not None:
        h = _decode_attention(ctx, [b.xattn for b in bps],
                              _norm([b.ln3 for b in bps], xs, ctx),
                              [(c["ek"][ai], c["ev"][ai]) for c in caches],
                              None)
        xs = [x + a for x, a in zip(xs, h)]
    zs = _norm([b.ln2 for b in bps], xs, ctx)
    if bps[0].moe is not None:
        m = _decode_moe(ctx, [b.moe for b in bps], zs)
    else:
        m = [L.swiglu_apply(b.mlp, z, ctx.dt) for b, z in zip(bps, zs)]
        if ctx.plan.mlp:
            m = _row_sum(ctx, m)
    return [x + a for x, a in zip(xs, m)]


def _decode_mamba(ctx, ps, xs, convs, sts) -> list:
    """Mamba2's decode step on each shard's heads (``ssm.apply_decode``'s
    rule), the gated norm's sum of squares summed across the shards,
    ``out_proj``'s partials in rank order; the conv and SSM states
    written in place."""
    cfg, dt = ctx.cfg, ctx.dt
    if not ctx.plan.ssm:
        outs = []
        for p, x, conv, st in zip(ps, xs, convs, sts):
            h, new = ssm_mod.apply_decode(p, cfg, x, {"conv": conv,
                                                      "ssm": st}, dt)
            conv.copy_(new["conv"])
            st.copy_(new["ssm"])
            outs.append(h)
        return outs
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32
    ys, sqs = [], []
    for p, x, conv, st in zip(ps, xs, convs, sts):
        B = x.shape[0]
        H_r = p.A_log.shape[0]
        di_r = H_r * Pd
        zxbcdt = x.to(dt) @ p.in_proj.to(dt)
        z = zxbcdt[..., :di_r]
        xbc, new_conv = ssm_mod._causal_conv(
            zxbcdt[..., di_r:2 * di_r + 2 * N], p.conv_w.to(dt),
            p.conv_b.to(dt), conv)
        xh = xbc[:, 0, :di_r].reshape(B, H_r, Pd).to(f32)
        Bc = xbc[:, 0, di_r:di_r + N].to(f32)
        Cc = xbc[:, 0, di_r + N:].to(f32)
        dts = ssm_mod.softplus(zxbcdt[:, 0, 2 * di_r + 2 * N:].to(f32)
                               + p.dt_bias)
        decay = torch.exp(dts * -torch.exp(p.A_log))
        h = st * decay[..., None, None] \
            + Bc[:, None, :, None] * (dts[..., None] * xh)[:, :, None, :]
        y = torch.einsum("bn,bhnp->bhp", Cc, h) + xh * p.D[None, :, None]
        conv.copy_(new_conv)
        st.copy_(h)
        yz = (y.reshape(B, 1, di_r).to(dt) * F.silu(z)).to(f32)
        ys.append(yz)
        sqs.append(torch.sum(yz * yz, dim=-1, keepdim=True))
    tot = lm.model_sum(ctx.mesh, sqs)
    outs = []
    for p, yf, t in zip(ps, ys, tot):
        rs = torch.rsqrt(t / cfg.d_inner + cfg.norm_eps)
        y = (yf * rs).to(dt) * p.norm_g.to(dt)
        outs.append(y @ p.out_proj.to(dt))
    return _row_sum(ctx, outs)


@torch.no_grad()
def forward_decode(ctx, pieces: list, tokens: list, caches: list) -> tuple:
    """One decode step of each held shard's tokens (``[b, 1]`` int32, its
    data shard's rows) against its cache (:func:`forward_prefill`'s),
    written in place, ``len`` advanced for every row: ``(logits,
    caches)``, each shard's float32 logits over its vocabulary columns.
    The residual ``[b, 1, d]`` is whole on every model shard of a data
    shard (module docstring)."""
    cfg = ctx.cfg
    meta = ctx.layout.meta
    tops = _tops(ctx, pieces)
    xs = _embed(ctx, tops, tokens)
    if ctx.plan.vocab:
        xs = lm.model_sum(ctx.mesh, xs)
    for i, b in enumerate(meta.blocks):
        bps = _views(ctx, pieces, f"blocks.{i}.", b)
        if b.ssm is None:
            xs = _decode_block(ctx, bps, xs, caches, i)
            continue
        h = _decode_mamba(ctx, [bp.ssm for bp in bps],
                          _norm([bp.ln1 for bp in bps], xs, ctx),
                          [c["conv"][i] for c in caches],
                          [c["ssm"][i] for c in caches])
        xs = [x + a for x, a in zip(xs, h)]
        if tfm._uses_shared(cfg, i):
            xs = _decode_block(ctx, [t.shared for t in tops], xs, caches,
                               i // cfg.attn_every)
    for c in caches:
        c["len"] += 1
    return _head(ctx, tops, _norm([t.lnf for t in tops], xs, ctx)), caches


@torch.no_grad()
def next_tokens(ctx, logits: list) -> list:
    """The greedy next token ``[b, 1]`` int32 of each held shard's logits
    (:func:`forward_decode`'s), the same on every model shard: the
    largest logit across the shards' columns, ties to the lowest index
    (``jnp.argmax``'s rule): each shard's first largest and its index,
    gathered, the first shard holding the largest."""
    if not ctx.plan.vocab:
        return [torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
                for lg in logits]
    best = []
    for lg, r in zip(logits, ctx.ranks):
        lg = lg[:, -1]
        idx = torch.argmax(lg, dim=-1, keepdim=True)
        # vocabulary indices are exact in float32 (< 2^24)
        best.append(torch.cat([torch.gather(lg, 1, idx),
                               (idx + r * lg.shape[-1]).to(torch.float32)],
                              dim=1))
    out = []
    for g in ctx.mesh.all_gather("model", best):
        at = torch.argmax(g[..., 0], dim=0, keepdim=True)
        out.append(torch.gather(g[..., 1], 0, at)[0].to(torch.int32)[:, None])
    return out


# ---------------------------------------------------------------------------
# state: ZeRO over the data shards within each model shard
# ---------------------------------------------------------------------------


def zero_layout(cfg, mesh, layout: Layout) -> list:
    """The ``optim.adamw.ZeroLeaf`` of every piece, reference leaf by
    reference leaf in the reference's order (own before shared): the
    reference's ZeRO dim of the leaf at the mesh's data size, split over
    the data-parallel shards where they divide the piece there; ``own``
    pieces sum their gradients over the data shards of one model index,
    ``shared`` ones over every shard."""
    from ..optim import adamw

    params, specs = tfm.abstract_params(cfg)
    zspecs = adamw.zero_spec_tree(specs, adamw.leaf_shapes(params),
                                  data_size=mesh.shape["data"])
    n = mesh.dp_size
    shapes = layout.piece_shapes()
    out = []
    for path, names in tfm.reference_leaves(params):
        stacked = path[0] in tfm._STACKED
        zs = zspecs[path]
        zdim = next((i for i, e in enumerate(zs)
                     if e is not None and "data" in (e if isinstance(e, tuple)
                                                     else (e,))), None)
        for kind in ("own", "shared"):
            idx = [layout.piece_of.get((layout.index[nm], kind))
                   for nm in names]
            if idx[0] is None:
                continue
            shape = ((len(names),) if stacked else ()) + shapes[idx[0]]
            dim = zdim if zdim is not None and shape[zdim] % n == 0 \
                and n > 1 else None
            out.append(adamw.ZeroLeaf(
                "/".join(path) + ("" if kind == "own" else "+shared"),
                tuple(idx), stacked, shape, zs, dim, n if dim is not None
                else 1, over="dp" if kind == "own" else "world",
                model_split=kind == "own" and layout.M > 1))
    return out


def init_state(params, layout: Layout, zl: list, mesh):
    """The step-0 ``ZeroState`` of whole ``params`` (a ``Transformer``):
    each held shard's float32 pieces as its master (``requires_grad``)
    and zero moments sliced by ``zl``."""
    from ..optim import adamw

    whole = [p.detach() for p in params.parameters()]
    master = []
    for s in mesh.local:
        ps = [x.to(device=mesh.device, dtype=torch.float32).contiguous()
              for x in layout.take(whole, mesh.model_index(s))]
        master.append([p.requires_grad_(True) for p in ps])
    return adamw.ZeroState(torch.zeros((), dtype=torch.int32,
                                       device=mesh.device), master,
                           adamw.zero_moments(zl, mesh),
                           adamw.zero_moments(zl, mesh))


def _whole_pieces(mesh, zl: list, moments: list) -> list:
    """Each held shard's whole pieces of ``moments`` (per shard, per
    ZeroLeaf; gathered over the data shards)."""
    out = [[None] * len(zl) for _ in mesh.local]
    for j, leaf in enumerate(zl):
        if leaf.dim is None:
            for i in range(len(mesh.local)):
                out[i][j] = moments[i][j]
            continue
        got = mesh.all_gather("dp", [mo[j].reshape(-1) for mo in moments])
        for i, g in enumerate(got):
            out[i][j] = leaf.unchunk(g)
    return out


def _leaf_part(layout: Layout, leaf) -> tuple:
    """(the reference leaf's path, the piece's kind, its layers' Part)."""
    i, kind = layout.pieces[leaf.index[0]]
    return leaf.key.removesuffix("+shared"), kind, layout.parts[i]


def whole_leaves(mesh, layout: Layout, zl: list, tree: list) -> dict:
    """The reference's whole leaves ``{path: tensor}`` of ``tree`` (per
    held shard, one whole piece per ZeroLeaf), for the first shard held:
    the own pieces all-gathered over the model shards (one exchange) and
    assembled with the shared ones (:meth:`Part.assemble`)."""
    own = [j for j, leaf in enumerate(zl) if leaf.model_split]
    owns = {}
    if own:
        got = mesh.all_gather("model", [torch.cat(
            [t[j].reshape(-1) for j in own]) for t in tree])[0]
        off = 0
        for j in own:
            x = tree[0][j]
            owns[j] = [got[m, off:off + x.numel()].view(x.shape)
                       for m in range(layout.M)]
            off += x.numel()
    by_key = {leaf.key: j for j, leaf in enumerate(zl)}
    out = {}
    for j, leaf in enumerate(zl):
        key, kind, part = _leaf_part(layout, leaf)
        if key in out:
            continue
        sj = by_key.get(key + "+shared")
        shared = tree[0][sj] if sj is not None else None
        out[key] = shared if j not in owns else part.assemble(owns[j],
                                                              shared)
    return out


def _nest(flat: dict) -> dict:
    tree = {}
    for key, t in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def checkpoint_leaves(mesh, layout: Layout, zl: list, state) -> dict:
    """The checkpoint's leaves of ``state`` (a model-sharded
    ``ZeroState``): the reference's paths and whole leaves, every shard
    taking part in the exchanges, the first held shard's copy returned."""
    from ..train.checkpoint import flatten_with_paths

    master = [[leaf.full([p.detach() for p in ps]) for leaf in zl]
              for ps in state.master]
    trees = [whole_leaves(mesh, layout, zl, t) for t in (
        master, _whole_pieces(mesh, zl, state.m),
        _whole_pieces(mesh, zl, state.v))]
    return flatten_with_paths((state.step,) + tuple(_nest(t) for t in trees))


def restore(mesh, layout: Layout, zl: list, whole: dict):
    """The ``ZeroState`` of the held shards from a checkpoint's whole
    leaves ``whole`` (``{path: tensor}``, :func:`checkpoint_leaves`'
    paths, whatever mesh wrote them)."""
    from ..optim import adamw

    dev = mesh.device
    master, ms, vs = [], [], []
    for s in mesh.local:
        r, q = mesh.model_index(s), mesh.dp_index(s)
        pieces = [None] * len(layout.pieces)
        mo = {"2": [], "3": []}
        for leaf in zl:
            key, kind, part = _leaf_part(layout, leaf)
            lead = 1 if leaf.stacked else 0
            w = part.take(whole[f"1/{key}"], r, kind, lead)
            for li, pi in enumerate(leaf.index):
                x = w[li] if leaf.stacked else w
                pieces[pi] = x.to(device=dev, dtype=torch.float32) \
                    .contiguous().requires_grad_(True)
            for t in mo:
                x = part.take(whole[f"{t}/{key}"], r, kind, lead)
                mo[t].append(leaf.take(x.to(device=dev, dtype=torch.float32),
                                       q).contiguous())
        master.append(pieces)
        ms.append(mo["2"])
        vs.append(mo["3"])
    step = whole["0"].to(device=dev, dtype=torch.int32).reshape(())
    return adamw.ZeroState(step, master, ms, vs)


def whole_params(layout: Layout, shards: list) -> list:
    """The whole parameters, ``Transformer.parameters()`` order, from every
    model shard's pieces (``shards[r]``: model index r's piece list)."""
    out = []
    for i, part in enumerate(layout.parts):
        o = layout.piece_of.get((i, "own"))
        s = layout.piece_of.get((i, "shared"))
        shared = shards[0][s] if s is not None else None
        out.append(shared if o is None else part.assemble(
            [sh[o] for sh in shards], shared))
    return out


def state_bytes(cfg, M: int) -> int:
    """The bytes of one model shard's float32 master, m and v at ``M``
    model shards on one data shard, counted from the layout's shapes (no
    allocation)."""
    layout = Layout(cfg, M)
    return 3 * 4 * sum(math.prod(s) for s in layout.piece_shapes())
