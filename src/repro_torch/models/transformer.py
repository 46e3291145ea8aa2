"""Model assembly for the dense, moe, vlm, ssm, hybrid and encdec
families: init, the training forward, prefill and decode with a cache.

The port of ``repro.models.transformer``. Parameters are
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

:func:`forward_train` is the reference's training loss: each layer cast
from the float32 master to the compute dtype inside the layer
(:func:`_cast_block`, the router and Mamba2's float32 leaves too) and
recomputed in the backward (``torch.utils.checkpoint`` for the
reference's ``jax.checkpoint``), the CE loss over chunks of the
sequence; :func:`to_reference_params` gives any tree of this structure
(a master, Adam's moments, gradients) as the reference's.

Not copied from the reference: the sharding constraints (``constrain``;
the model axis is ``models.tensor_parallel``'s forward), ``lax.scan`` (a
Python loop over the layers, the encoder's too), ``lax.cond`` for the
hybrid's shared block
(a Python ``if`` on the static layer index), and the functional cache. The port's ``forward_decode`` writes the new K/V,
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

import functools
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


#: the parameter lists the reference stacks ``[L, ...]``
_STACKED = ("blocks", "enc_blocks")


def _ref_path(name: str) -> tuple:
    """The reference's tree path of the port's parameter ``name``: the
    layer index dropped (``blocks.3.attn.wq.w`` -> ``blocks/attn/wq/w``);
    the moe routed experts' ``experts.wi`` -> ``wi``, the shared experts'
    ``shared.wi`` -> ``shared/wi/w``."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        del parts[1]
    if "moe" in parts:
        j = parts.index("moe") + 1
        if parts[j] == "experts":
            del parts[j]
        elif parts[j] == "shared":
            parts.append("w")
    return tuple(parts)


def reference_leaves(params: nn.Module) -> list:
    """``[(path, names)]``: each leaf of the reference's parameter tree, in
    its leaf order (``jax.tree.leaves``: sorted paths), with the port's
    parameter names that make it (one per layer, in layer order, for a
    stacked leaf). ``params``: a :class:`Transformer`, or a module of its
    structure (the optimizer's moments)."""
    groups = {}
    for name, _ in params.named_parameters():
        groups.setdefault(_ref_path(name), []).append(name)
    return sorted(groups.items())


def reference_groups(params: nn.Module) -> list:
    """The reference's leaves as lists of indices into
    ``list(params.parameters())`` (``optim.adamw.global_norm``'s
    ``groups``)."""
    index = {n: i for i, (n, _) in enumerate(params.named_parameters())}
    return [[index[n] for n in names] for _, names in
            reference_leaves(params)]


def to_reference_params(params: nn.Module, *, host: bool = True) -> dict:
    """The inverse of :func:`load_reference_params`: the reference's
    parameter tree (nested dicts, the blocks stacked ``[L, ...]``, its
    keys), from ``params`` or a module of its structure: numpy arrays on
    the host (bfloat16 as float32), or with ``host=False`` tensors where
    ``params`` lie (a checkpoint then copies each leaf once)."""
    named = dict(params.named_parameters())
    tree = {}
    for path, names in reference_leaves(params):
        ts = [named[n].detach() for n in names]
        t = torch.stack(ts) if path[0] in _STACKED else ts[0]
        if host:
            t = t.to(torch.float32) if t.dtype == torch.bfloat16 else t
            t = t.cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def load_reference_params(cfg: ModelConfig, tree, device=None,
                          dtype=None) -> Transformer:
    """The reference's parameter pytree (``repro.models.transformer.
    init_params``' first result, its leaves as numpy arrays with the
    blocks stacked ``[L, ...]``; Mamba2's leaves are arrays, not
    ``{"w": ...}``, the hybrid's ``shared`` block is not stacked, and the
    encdec ``enc_blocks`` are stacked ``[enc_layers, ...]``; a leaf may
    also be a tensor, as a restored checkpoint's) as the port's
    :class:`Transformer` in ``dtype`` (None: ``cfg.param_dtype``) on
    ``device`` (None: the GPU)."""
    dev = _device.resolve_device(device)
    params = Transformer(cfg, dtype=dtype, device=dev)
    named = dict(params.named_parameters())
    for path, names in reference_leaves(params):
        arr = tree
        for k in path:
            arr = arr[k]
        if not torch.is_tensor(arr):
            arr = torch.from_numpy(np.array(arr, dtype=np.float32))
        for i, name in enumerate(names):
            a = arr[i] if path[0] in _STACKED else arr
            p = named[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(a.shape)} for a parameter of "
                                 f"shape {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(a)
    return params


def _leaf_spec(path: tuple, ndim: int) -> tuple:
    """The reference's ``PartitionSpec`` of the leaf at ``path`` as a
    tuple, for one layer's ``ndim`` dims: ``"model"`` on the routed
    experts' expert dim, on the input dim of a row-parallel product
    (``wo``, ``out_proj``), nowhere on the norms' gains, the router, the
    projector and Mamba2's float32 leaves, else on the last dim
    (column-parallel products and biases, the embedding, the head,
    Mamba2's conv and gated norm)."""
    if path[0] == "projector" or path[-1] in ("g", "router", "A_log", "D",
                                              "dt_bias"):
        return (None,) * ndim
    if path[-2] == "moe" and path[-1] in ("wi", "wg", "wo"):
        return ("model",) + (None,) * (ndim - 1)
    if path[-1] == "out_proj" or path[-2:] == ("wo", "w"):
        return (None,) * (ndim - 2) + ("model", None)
    return (None,) * (ndim - 1) + ("model",)


def abstract_params(cfg: ModelConfig):
    """``(parameters, specs)`` with no allocation (the dry-run path): a
    :class:`Transformer` on the meta device in ``cfg.param_dtype``, and
    the reference's spec tree as plain data, ``{path: spec}`` over
    :func:`reference_leaves`' paths in their order, each spec a tuple of
    mesh axis names or ``None`` per dim (a stacked leaf's first, the layer
    dim, ``None``): the dry-run's record of the reference's layout, and the
    ZeRO dims of ``models.tensor_parallel``'s pieces."""
    params = Transformer(cfg, device="meta")
    named = dict(params.named_parameters())
    specs = {}
    for path, names in reference_leaves(params):
        spec = _leaf_spec(path, named[names[0]].dim())
        specs[path] = (None,) + spec if path[0] in _STACKED else spec
    return params, specs


def param_specs(cfg: ModelConfig) -> dict:
    return abstract_params(cfg)[1]


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


def _encode(cfg, params: Transformer, batch, dtype, *, train: bool = False):
    """The encoder: ``batch["frames"]`` ``[B, Se, STUB_DIM]`` in the
    compute dtype through the audio stub's ``projector``, then the
    encoder blocks (non-causal self-attention with RoPE at the frame
    positions, then SwiGLU), then ``enc_lnf``. Returns ``[B, Se, d]``.
    ``train``: each block cast and recomputed as :func:`_scan_blocks`'."""
    frames = batch["frames"].to(L.as_dtype(dtype))
    h = L.dense_apply(params.projector, frames, dtype)
    B, Se, _ = h.shape
    pos = torch.arange(Se, device=h.device)[None, :].expand(B, Se)
    for b in params.enc_blocks:
        if train:
            h = _remat(lambda h, b=b: _block_full(
                cfg, _cast_block(b, dtype), h, pos, dtype, causal=False)[0], h)
        else:
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


# ---------------------------------------------------------------------------
# Training: the forward with per-layer cast and recompute, chunked CE
# ---------------------------------------------------------------------------


def _view(m: nn.Module, f) -> types.SimpleNamespace:
    """``m``'s tree with every parameter through ``f``: the attributes the
    ``*_apply`` functions read (``w``, ``g``, ``attn``, ``router``, ...),
    an absent child or bias ``None``."""
    ns = types.SimpleNamespace(**_absent(m))
    for name, p in m._parameters.items():
        setattr(ns, name, None if p is None else f(p))
    for name, c in m._modules.items():
        setattr(ns, name, None if c is None else _view(c, f))
    return ns


def _absent(m: nn.Module) -> dict:
    """The children and parameters ``m`` was built without (``head``,
    ``attn``, a dense layer's ``b``, ...): plain ``None`` attributes."""
    return {k: None for k, v in vars(m).items()
            if v is None and not k.startswith("_")}


def _cast_block(b: nn.Module, dtype) -> types.SimpleNamespace:
    """The reference's per-layer master -> compute cast (``_cast_block``):
    every floating leaf of the block to ``dtype`` by a differentiable
    ``.to``, the moe router and Mamba2's ``A_log``, ``D`` and ``dt_bias``
    included (not :func:`cast_params`' serving rule, which keeps those in
    float32). One layer's compute copy is live at a time."""
    dt = L.as_dtype(dtype)
    return _view(b, lambda t: t.to(dt) if t.is_floating_point() else t)


def to_compute(cfg: ModelConfig, master: Transformer) -> types.SimpleNamespace:
    """The parameters a training step reads (the reference trainer's
    ``to_compute``): every leaf outside the layer stacks (``embed``,
    ``lnf``, ``head``, the hybrid's ``shared`` block, ``enc_lnf``,
    ``projector``) cast to the compute dtype once, differentiably; the
    ``blocks`` and ``enc_blocks`` left as the master's, for
    :func:`_scan_blocks` to cast one layer at a time."""
    dt = _dt(cfg)
    out = types.SimpleNamespace(**_absent(master))
    for name, c in master._modules.items():
        if name in _STACKED or c is None:
            setattr(out, name, c)
        else:
            setattr(out, name, _view(c, lambda t: t.to(dt)
                                     if t.is_floating_point() else t))
    return out


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    saved (``torch.utils.checkpoint``, non-reentrant): the reference's
    ``jax.checkpoint`` with ``nothing_saveable``; only the inputs are
    kept. Without autograd, a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _apply_block(cfg, bp, x, positions, dtype, layer_idx: int, shared=None):
    """One training block on ``x`` (the reference's ``_apply_block``):
    attention then MLP or MoE (dense, moe, vlm), or Mamba2 then, after
    every ``attn_every``-th layer of the hybrid, the ``shared`` block (a
    Python ``if`` on the static index for the reference's ``lax.cond``).
    Returns (x, aux): the moe family's ``moe_lb``/``moe_z``, else {}."""
    aux = {}
    if cfg.family in ("dense", "moe", "vlm"):
        h, _ = attn.apply_full(
            bp.attn, cfg, L.rmsnorm_apply(bp.ln1, x, cfg.norm_eps, dtype),
            positions, dtype, causal=True)
        x = x + h
        z = L.rmsnorm_apply(bp.ln2, x, cfg.norm_eps, dtype)
        if bp.moe is not None:
            m, aux = moe_mod.apply(bp.moe, cfg, z, dtype)
        else:
            m = L.swiglu_apply(bp.mlp, z, dtype)
        return x + m, aux
    h, _ = ssm_mod.apply_full(
        bp.ssm, cfg, L.rmsnorm_apply(bp.ln1, x, cfg.norm_eps, dtype), dtype,
        state=False)
    x = x + h
    if shared is not None and _uses_shared(cfg, layer_idx):
        x = _block_full(cfg, shared, x, positions, dtype)[0]
    return x, aux


def _scan_blocks(cfg, blocks, x, positions, dtype, shared=None):
    """The layer loop of the training forward (the reference's
    ``lax.scan``): each layer, its cast included, under :func:`_remat`.
    Returns (x, {"moe_lb", "moe_z"}), the aux terms summed over the
    layers in float32."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    lb, z = zero, zero
    for i, b in enumerate(blocks):
        def layer(x, b=b, i=i):
            x, aux = _apply_block(cfg, _cast_block(b, dtype), x, positions,
                                  dtype, i, shared)
            return (x, aux["moe_lb"], aux["moe_z"]) if aux else (x,)

        out = _remat(layer, x)
        x = out[0]
        if len(out) > 1:
            lb, z = lb + out[1], z + out[2]
    return x, {"moe_lb": lb, "moe_z": z}


def _ce_chunk(cfg, xc, head_w, lc, mc):
    """The summed cross-entropy of one chunk: float32 logits of the
    compute-dtype product, padded vocab columns at -1e30."""
    logits = (xc @ head_w.to(xc.dtype)).to(torch.float32)
    vpad = head_w.shape[-1]
    if vpad > cfg.vocab:
        cols = torch.arange(vpad, device=logits.device)
        logits = torch.where(cols < cfg.vocab, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum((logz - ll) * mc)


def chunked_ce_loss(cfg, head_w, x, labels, mask, *, chunk: int = 512):
    """x: [B, S, d]; labels, mask: [B, S]. Returns (sum_loss, count): the
    sequence padded to whole chunks of ``min(chunk, S)``, each chunk's
    logits made and recomputed in the backward (:func:`_remat`), so the
    ``[B, S, vocab]`` float32 logits never exist at once. A tied head is
    ``embed.w.T``: the embedding's gradient then sums its gather's and
    this product's."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + _remat(functools.partial(_ce_chunk, cfg), x[:, sl],
                               head_w, labels[:, sl], mask[:, sl])
    return total, torch.clamp_min(mask.sum(), 1.0)


def _decode_stack_full(cfg, params, x, positions, enc_out, dtype):
    """The encdec decoder over whole sequences (train): per layer, cast
    and recomputed as :func:`_scan_blocks`', the causal self-attention,
    the cross-attention over ``enc_out``'s K/V and SwiGLU. The reference
    saves the weight products of these layers
    (``dots_with_no_batch_dims_saveable``); the port recomputes the whole
    layer, which changes only the memory held and the work redone."""
    def layer(x, b):
        bp = _cast_block(b, dtype)
        enc = attn.cross_kv(bp.xattn, cfg, enc_out, dtype)
        return _block_full(cfg, bp, x, positions, dtype, enc=enc)[0]

    for b in params.blocks:
        x = _remat(layer, x, b)
    return x


def forward_train(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The scalar training loss (CE + 0.01 moe_lb + 0.001 moe_z).

    ``params``: the master :class:`Transformer` or its
    :func:`to_compute` view; the blocks are cast one layer at a time.
    ``batch``: ``tokens``, ``labels``, ``mask`` ``[B, S]`` (the vlm
    family's ``patches``, the encdec family's ``frames``)."""
    _check_family(cfg)
    dtype = _dt(cfg)
    if cfg.family == "encdec":
        enc_out = _encode(cfg, params, batch, dtype, train=True)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed_apply(params.embed, tokens, dtype)
        pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        x = _decode_stack_full(cfg, params, x, pos, enc_out, dtype)
        aux = {"moe_lb": 0.0, "moe_z": 0.0}
        labels, mask = batch["labels"], batch["mask"].to(torch.float32)
    else:
        x, pos, labels, mask = _embed_inputs(cfg, params, batch, dtype)
        x, aux = _scan_blocks(cfg, params.blocks, x, pos, dtype,
                              shared=params.shared)
    x = L.rmsnorm_apply(params.lnf, x, cfg.norm_eps, dtype)
    head = params.head.w if params.head is not None else params.embed.w.T
    total, count = chunked_ce_loss(cfg, head, x, labels, mask)
    loss = total / count
    return loss + 0.01 * aux["moe_lb"] + 0.001 * aux["moe_z"]
