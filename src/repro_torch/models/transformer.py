"""Model assembly for the dense, moe, vlm, ssm, hybrid and encdec
families: init, prefill and decode with a cache.

The port of ``repro.models.transformer``'s serving path. Parameters are
an ``nn.Module`` tree (:class:`Transformer`: ``embed``, ``blocks[l]``
with ``ln1``, ``attn``, ``ln2`` and ``mlp`` (dense, vlm; encdec adds
``ln3`` and the cross-attention ``xattn``) or ``moe`` (``models.moe``),
or ``ln1`` and ``ssm`` (``models.ssm``'s Mamba2; ssm, hybrid), then
``lnf``, ``head``, for the hybrid family the ``shared`` attention +
SwiGLU block, for encdec the encoder's ``enc_blocks`` and ``enc_lnf``,
and for the vision and audio stubs ``projector``) holding the
reference's tensors layer by layer where the reference stacks them
``[L, ...]``; the reference's function names are the entry points. The
moe family routes through ``moe.apply``; the vlm family prepends its
projected patches in :func:`_embed_inputs` and then decodes as the dense
family. The hybrid family runs the shared block after every
``attn_every``-th Mamba2 layer, its K/V in attention cache
``idx // attn_every``. The encdec family encodes ``batch["frames"]``
(the audio stub's projector, then non-causal encoder blocks with RoPE on
the frame positions) in :func:`_prefill_encdec`, which writes each
decoder layer's cross-attention K/V into ``cache["ek"/"ev"]``; decode
reads them and never writes them.

Not copied from the reference: the sharding constraints (``constrain``;
the port runs on one card), the per-layer remat and ``lax.scan`` (a
Python loop over the layers, the encoder's too), ``lax.cond`` for the
hybrid's shared block (a Python ``if`` on the static layer index), and
the functional cache. The port's ``forward_decode`` writes the new K/V,
conv and SSM states and ``len`` into the cache it is given, in place, so
a decode step over static buffers captures into one CUDA graph
(``serving.engine``); the encdec prefill writes ``k``/``v`` and
``ek``/``ev`` into the cache it allocates, in place.
:func:`cast_params` casts the weights to the compute dtype once (the moe
router and Mamba2's ``A_log``, ``D`` and ``dt_bias`` stay float32, as
the reference's); ``layers.dense_apply``'s per-call cast is then a no-op
with the same bits. ``init_params(..., dtype=cfg.dtype)`` draws the
parameters straight into that one copy.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import _device
from . import attention as attn
from . import io_spec
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig

#: the families the port carries: all of the reference's
PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _dt(cfg) -> torch.dtype:
    return L.as_dtype(cfg.dtype)


def _pdt(cfg) -> torch.dtype:
    return L.as_dtype(cfg.param_dtype)


def _check_family(cfg: ModelConfig) -> None:
    """A family neither package knows raises ``ValueError``, as the
    reference's ``_block_init`` does."""
    if cfg.family not in PORTED:
        raise ValueError(cfg.family)


class Block(nn.Module):
    """One pre-norm block: ``attn`` and ``mlp`` (dense, vlm, the hybrid's
    shared block, the encoder) or ``moe``, each after its norm; the
    encdec decoder's cross-attention ``xattn`` after ``ln3``, between
    them; or ``ssm`` after ``ln1`` (ssm, hybrid)."""

    def __init__(self, ln1, attention=None, ln2=None, *, mlp=None, moe=None,
                 ssm=None, ln3=None, xattn=None):
        super().__init__()
        self.ln1, self.attn, self.ln2 = ln1, attention, ln2
        self.mlp, self.moe, self.ssm = mlp, moe, ssm
        self.ln3, self.xattn = ln3, xattn


class Transformer(nn.Module):
    """The parameter tree of a model (module docstring), drawn from
    ``gen`` in the order embed, each block (attention, then its MLP or
    MoE, then for encdec its cross-attention; or its Mamba2), head, the
    shared block (attention, then its MLP), the encoder blocks (attention,
    then MLP), projector; float32 draws cast to ``dtype``
    (``layers.draw_``). The order is the port's own: the tests carry the
    reference's parameters across (:func:`load_reference_params`)."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None,
                 gen=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dt = _pdt(cfg) if dtype is None else L.as_dtype(dtype)
        d = cfg.d_model
        kw = dict(device=device)

        def block(family):
            ln1 = L.rmsnorm_init(d, dt, **kw)
            if family in ("ssm", "hybrid"):
                return Block(ln1, ssm=ssm_mod.init(gen, cfg, dt, **kw))
            a, ln2 = attn.init(gen, cfg, dt, **kw), L.rmsnorm_init(d, dt, **kw)
            if family == "moe":
                return Block(ln1, a, ln2, moe=moe_mod.init(gen, cfg, dt, **kw))
            mlp = L.swiglu_init(gen, d, cfg.d_ff, dt, **kw)
            if family == "encdec":
                return Block(ln1, a, ln2, mlp=mlp,
                             ln3=L.rmsnorm_init(d, dt, **kw),
                             xattn=attn.init(gen, cfg, dt, **kw))
            return Block(ln1, a, ln2, mlp=mlp)

        self.embed = L.embed_init(gen, cfg.vocab_padded, d, dt, **kw)
        self.blocks = nn.ModuleList(block(cfg.family)
                                    for _ in range(cfg.n_layers))
        self.lnf = L.rmsnorm_init(d, dt, **kw)
        self.head = None if cfg.tie_embeddings else L.dense_init(
            gen, d, cfg.vocab_padded, dt, **kw)
        # one attention + SwiGLU block shared by every attn_every-th layer
        self.shared = block("dense") if cfg.family == "hybrid" else None
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(block("dense")
                                            for _ in range(cfg.enc_layers))
            self.enc_lnf = L.rmsnorm_init(d, dt, **kw)
        else:
            self.enc_blocks = self.enc_lnf = None
        self.projector = (L.dense_init(gen, io_spec.STUB_DIM, d, dt, **kw)
                          if cfg.frontend in ("vision_stub", "audio_stub")
                          else None)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.w.dtype

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def init_params(cfg: ModelConfig, seed: int, *, device=None,
                dtype=None) -> Transformer:
    """Random parameters in ``dtype`` (None: ``cfg.param_dtype``) on
    ``device`` (None: the GPU), drawn from a ``torch.Generator`` on that
    device seeded with ``seed``, with the reference's distributions.

    Each tensor is drawn in float32 and cast (``layers.draw_``), so
    ``init_params(cfg, s, dtype=cfg.dtype)`` equals
    ``cast_params(init_params(cfg, s), cfg.dtype)`` bit for bit, the
    float32 router and Mamba2 parameters included, with one copy of the
    parameters and one float32 tensor at a time on the device instead of
    the float32 model."""
    dev = _device.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return Transformer(cfg, dtype=dtype, device=dev, gen=gen)


def cast_params(params: Transformer, dtype, *, device=None) -> Transformer:
    """``params`` with every tensor in ``dtype`` on ``device`` (None: where
    it is), made once: the same module when nothing changes, else a new
    one filled by ``copy_`` (round to nearest even, as ``astype``). The
    moe router and Mamba2's ``A_log``, ``D`` and ``dt_bias`` stay
    float32: the reference casts no parameter when it serves, and draws
    them in float32."""
    dt = L.as_dtype(dtype)
    dev = params.device if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:    # "cuda": the current one
        dev = torch.device("cuda", torch.cuda.current_device())
    if params.dtype == dt and params.device == dev:
        return params
    out = Transformer(params.cfg, dtype=dt, device=dev)
    with torch.no_grad():
        for dst, src in zip(out.parameters(), params.parameters()):
            dst.copy_(src)
    return out


def load_reference_params(cfg: ModelConfig, tree, device=None) -> Transformer:
    """The reference's parameter pytree (``repro.models.transformer.
    init_params``' first result, its leaves as numpy arrays with the
    blocks stacked ``[L, ...]``; Mamba2's leaves are arrays, not
    ``{"w": ...}``, the hybrid's ``shared`` block is not stacked, and the
    encdec ``enc_blocks`` are stacked ``[enc_layers, ...]``) as
    the port's :class:`Transformer` in ``cfg.param_dtype`` on ``device``
    (None: the GPU)."""
    dev = _device.resolve_device(device)
    params = Transformer(cfg, device=dev)

    def put(p: nn.Parameter, arr) -> None:
        a = np.array(arr, dtype=np.float32)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape {a.shape} for a parameter of shape "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(a))

    def put_dense(p: L.Dense, leaf, i=None) -> None:
        put(p.w, leaf["w"] if i is None else leaf["w"][i])
        if p.b is not None:
            put(p.b, leaf["b"] if i is None else leaf["b"][i])

    def put_attn_mlp(b: Block, t, i=None) -> None:
        def at(a):
            return a if i is None else a[i]

        put(b.ln1.g, at(t["ln1"]["g"]))
        put(b.ln2.g, at(t["ln2"]["g"]))
        for name in ("wq", "wk", "wv", "wo"):
            put_dense(getattr(b.attn, name), t["attn"][name], i)
        if b.mlp is not None:
            for name in ("wi", "wg", "wo"):
                put_dense(getattr(b.mlp, name), t["mlp"][name], i)
        if b.xattn is not None:
            put(b.ln3.g, at(t["ln3"]["g"]))
            for name in ("wq", "wk", "wv", "wo"):
                put_dense(getattr(b.xattn, name), t["xattn"][name], i)

    put(params.embed.w, tree["embed"]["w"])
    blk = tree["blocks"]
    for i, b in enumerate(params.blocks):
        if b.ssm is not None:
            put(b.ln1.g, blk["ln1"]["g"][i])
            for name, t in b.ssm.named_parameters():
                put(t, blk["ssm"][name][i])
            continue
        put_attn_mlp(b, blk, i)
        if b.moe is not None:
            m = blk["moe"]
            put(b.moe.router, m["router"][i])
            for name in ("wi", "wg", "wo"):
                put(getattr(b.moe.experts, name), m[name][i])
                if b.moe.shared is not None:        # stacked [L, n_sh, ...]
                    put(getattr(b.moe.shared, name), m["shared"][name]["w"][i])
    put(params.lnf.g, tree["lnf"]["g"])
    if params.head is not None:
        put_dense(params.head, tree["head"])
    if params.shared is not None:
        put_attn_mlp(params.shared, tree["shared"])
    if params.enc_blocks is not None:
        for i, b in enumerate(params.enc_blocks):
            put_attn_mlp(b, tree["enc_blocks"], i)
        put(params.enc_lnf.g, tree["enc_lnf"]["g"])
    if params.projector is not None:
        put_dense(params.projector, tree["projector"])
    return params


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------


def n_attn_caches(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               *, device=None) -> dict:
    """Zeroed decode cache for a batch, the reference's keys in its order:
    ``k``/``v`` ``[n_attn_caches, batch, max_len, KV, hd]`` in the
    compute dtype and ``len`` ``[batch]`` int32 where the family attends;
    for ssm and hybrid ``conv`` ``[L, batch, K-1, d_inner + 2N]`` in the
    compute dtype and ``ssm`` ``[L, batch, H, N, P]`` in float32 (the ssm
    family's ``len`` after them); for encdec the encoder's K/V ``ek``/``ev``
    ``[L, batch, enc_len, KV, hd]`` in the compute dtype, last."""
    _check_family(cfg)
    dev = _device.resolve_device(device)
    dt = _dt(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    na = n_attn_caches(cfg)

    def zeros(shape, t=dt):
        return torch.zeros(shape, dtype=t, device=dev)

    cache = {}
    if na:
        cache["k"] = zeros((na, batch, max_len, KV, hd))
        cache["v"] = zeros((na, batch, max_len, KV, hd))
        cache["len"] = zeros((batch,), torch.int32)
    if cfg.family in ("ssm", "hybrid"):
        ch = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, ch))
        cache["ssm"] = zeros((cfg.n_layers, batch, cfg.ssm_heads,
                              cfg.ssm_state, cfg.ssm_head_dim), torch.float32)
        if cfg.family == "ssm":
            cache["len"] = zeros((batch,), torch.int32)
    if cfg.family == "encdec":
        cache["ek"] = zeros((cfg.n_layers, batch, enc_len, KV, hd))
        cache["ev"] = zeros((cfg.n_layers, batch, enc_len, KV, hd))
    return cache


def _embed_inputs(cfg, params: Transformer, batch, dtype):
    """Token (+ vision stub) embedding. Returns (x, positions, labels,
    mask). The vision stub's ``batch["patches"]`` ``[B, P, STUB_DIM]``
    go through ``projector`` and come first; labels and mask gain P zeros
    in front, and positions run over the whole length. The audio stub's
    frames go to the encoder (:func:`_encode`), so here it is tokens
    only, as in the reference."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    x = L.embed_apply(params.embed, tokens, dtype)
    labels = batch.get("labels")
    if cfg.frontend == "vision_stub":
        patches = batch["patches"].to(L.as_dtype(dtype))     # [B, P, 1024]
        proj = L.dense_apply(params.projector, patches, dtype)
        x = torch.cat([proj, x], dim=1)
        if labels is not None:
            P = proj.shape[1]
            labels = torch.cat([torch.zeros((B, P), dtype=labels.dtype,
                                            device=dev), labels], dim=1)
            mask = torch.cat([torch.zeros((B, P), dtype=torch.float32,
                                          device=dev),
                              batch["mask"].to(torch.float32)], dim=1)
        else:
            mask = None
    else:
        mask = batch.get("mask")
        if mask is not None:
            mask = mask.to(torch.float32)
        elif labels is not None:
            mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
    S = x.shape[1]
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    return x, positions, labels, mask


def _logits_last(cfg, params: Transformer, x):
    """Logits for the last position only (decode). x: [B, 1, d]. Padded
    vocab columns are masked so sampling/argmax never picks them."""
    head = params.head.w if params.head is not None else params.embed.w.T
    logits = (x @ head.to(x.dtype)).to(torch.float32)
    if head.shape[-1] > cfg.vocab:
        cols = torch.arange(head.shape[-1], device=logits.device)
        logits = torch.where(cols < cfg.vocab, logits, -1e30)
    return logits


def _mlp(b: Block, cfg, z, dtype):
    """The block's MLP or MoE on ``z``; the aux terms are dropped, as the
    reference's serving paths drop them."""
    if b.moe is not None:
        return moe_mod.apply(b.moe, cfg, z, dtype, aux=False)[0]
    return L.swiglu_apply(b.mlp, z, dtype)


def _uses_shared(cfg, i: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``i``."""
    return cfg.family == "hybrid" and i % cfg.attn_every == cfg.attn_every - 1


def _cross(b: Block, cfg, x, ek, ev, dtype):
    """The encdec decoder block's cross-attention sublayer on ``x``."""
    return x + attn.apply_cross(
        b.xattn, cfg, L.rmsnorm_apply(b.ln3, x, cfg.norm_eps, dtype), ek, ev,
        dtype)


def _block_full(cfg, b: Block, x, pos, dtype, *, causal=True, enc=None):
    """A block over whole sequences: self-attention, the cross-attention
    over ``enc`` = (ek, ev) where given, then the MLP or MoE. Returns
    (x, k, v)."""
    h, (k, v) = attn.apply_full(
        b.attn, cfg, L.rmsnorm_apply(b.ln1, x, cfg.norm_eps, dtype), pos,
        dtype, causal=causal)
    x = x + h
    if enc is not None:
        x = _cross(b, cfg, x, *enc, dtype)
    z = L.rmsnorm_apply(b.ln2, x, cfg.norm_eps, dtype)
    return x + _mlp(b, cfg, z, dtype), k, v


def _encode(cfg, params: Transformer, batch, dtype):
    """The encoder: ``batch["frames"]`` ``[B, Se, STUB_DIM]`` in the
    compute dtype through the audio stub's ``projector``, then the
    encoder blocks (non-causal self-attention with RoPE at the frame
    positions, then SwiGLU), then ``enc_lnf``. Returns ``[B, Se, d]``."""
    frames = batch["frames"].to(L.as_dtype(dtype))
    h = L.dense_apply(params.projector, frames, dtype)
    B, Se, _ = h.shape
    pos = torch.arange(Se, device=h.device)[None, :].expand(B, Se)
    for b in params.enc_blocks:
        h = _block_full(cfg, b, h, pos, dtype, causal=False)[0]
    return L.rmsnorm_apply(params.enc_lnf, h, cfg.norm_eps, dtype)


def _prefill_encdec(cfg, params: Transformer, batch, max_len: int):
    """The encdec prefill: encode the frames, then per decoder layer the
    causal self-attention (K/V into ``cache["k"/"v"][i, :, :S]``), the
    encoder K/V (``cross_kv``, into ``cache["ek"/"ev"][i]``), the
    cross-attention over them and SwiGLU. Returns (last-position logits,
    cache)."""
    dtype = _dt(cfg)
    enc_out = _encode(cfg, params, batch, dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_apply(params.embed, tokens, dtype)
    pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    cache = init_cache(cfg, B, max_len, enc_out.shape[1], device=x.device)
    for i, b in enumerate(params.blocks):
        ek, ev = attn.cross_kv(b.xattn, cfg, enc_out, dtype)
        cache["ek"][i] = ek
        cache["ev"][i] = ev
        x, k, v = _block_full(cfg, b, x, pos, dtype, enc=(ek, ev))
        cache["k"][i, :, :S] = k.to(dtype)
        cache["v"][i, :, :S] = v.to(dtype)
    x = L.rmsnorm_apply(params.lnf, x, cfg.norm_eps, dtype)
    logits = _logits_last(cfg, params, x[:, -1:, :])
    cache["len"].fill_(S)
    return logits, cache


def forward_prefill(cfg: ModelConfig, params: Transformer, batch,
                    max_len: int):
    """Process a prompt; returns (last-position logits, populated cache)."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return _prefill_encdec(cfg, params, batch, max_len)
    dtype = _dt(cfg)
    x, pos, _, _ = _embed_inputs(cfg, params, batch, dtype)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max_len, device=x.device)
    for i, b in enumerate(params.blocks):
        if b.ssm is None:
            x, k, v = _block_full(cfg, b, x, pos, dtype)
            cache["k"][i, :, :S] = k.to(dtype)
            cache["v"][i, :, :S] = v.to(dtype)
            continue
        h, st = ssm_mod.apply_full(
            b.ssm, cfg, L.rmsnorm_apply(b.ln1, x, cfg.norm_eps, dtype), dtype)
        x = x + h
        cache["conv"][i] = st["conv"]
        cache["ssm"][i] = st["ssm"]
        if _uses_shared(cfg, i):
            x, k, v = _block_full(cfg, params.shared, x, pos, dtype)
            cache["k"][i // cfg.attn_every, :, :S] = k.to(dtype)
            cache["v"][i // cfg.attn_every, :, :S] = v.to(dtype)
    x = L.rmsnorm_apply(params.lnf, x, cfg.norm_eps, dtype)
    logits = _logits_last(cfg, params, x[:, -1:, :])
    cache["len"].fill_(S)
    return logits, cache


def decode_hidden(cfg: ModelConfig, params: Transformer, token, cache):
    """One decode step up to the final norm: the hidden state ``[B, 1, d]``
    that the head reads. Writes the step's K/V and its conv and SSM states
    into ``cache`` and advances ``cache["len"]`` for every row, in place,
    as the reference's ``forward_decode`` advances it for every slot. The
    encdec decoder attends over ``cache["ek"/"ev"]`` and leaves them as
    they are."""
    _check_family(cfg)
    dtype = _dt(cfg)
    x = L.embed_apply(params.embed, token, dtype)
    clen = cache["len"]

    def attend(b: Block, x, ai: int):
        h, _, _ = attn.apply_decode(
            b.attn, cfg, L.rmsnorm_apply(b.ln1, x, cfg.norm_eps, dtype),
            cache["k"][ai], cache["v"][ai], clen, dtype)
        x = x + h
        if b.xattn is not None:
            x = _cross(b, cfg, x, cache["ek"][ai], cache["ev"][ai], dtype)
        z = L.rmsnorm_apply(b.ln2, x, cfg.norm_eps, dtype)
        return x + _mlp(b, cfg, z, dtype)

    for i, b in enumerate(params.blocks):
        if b.ssm is None:
            x = attend(b, x, i)
            continue
        conv, st = cache["conv"][i], cache["ssm"][i]
        h, new = ssm_mod.apply_decode(
            b.ssm, cfg, L.rmsnorm_apply(b.ln1, x, cfg.norm_eps, dtype),
            {"conv": conv, "ssm": st}, dtype)
        x = x + h
        conv.copy_(new["conv"])
        st.copy_(new["ssm"])
        if _uses_shared(cfg, i):
            x = attend(params.shared, x, i // cfg.attn_every)
    clen += 1
    return L.rmsnorm_apply(params.lnf, x, cfg.norm_eps, dtype)


def forward_decode(cfg: ModelConfig, params: Transformer, token, cache):
    """One decode step. token: [B, 1] int32. Returns (logits, cache), the
    cache the one given, updated in place (:func:`decode_hidden`)."""
    x = decode_hidden(cfg, params, token, cache)
    return _logits_last(cfg, params, x), cache
