"""GQA attention with chunked (flash-style) softmax and KV caching.

The port of ``repro.models.attention``, dense path. ``flash_attention``
is the reference's online softmax over query and KV chunks in torch ops,
chunk sizes, padding masks, causal chunk skip, ``NEG_INF`` and the final
``max(s, 1e-30)`` included; it launches no kernel of this repository
(the reference's is jnp, not Pallas). Its loops are Python loops over
chunk counts that the shapes fix, so a decode step runs no host sync and
captures into a CUDA graph.

``apply_decode`` writes the new K/V into the cache in place (the
reference returns a new cache): a slot whose ``cache_len`` has reached
the cache's length writes nothing, as the reference's one-hot add writes
nothing there. ``cross_kv`` and ``apply_cross`` are the encoder-decoder
family's cross-attention: K/V projected from the encoder output once, the
query from the decoder, neither rotated (RoPE stays in the self-attention
of both stacks), over every encoder position (no ``kv_len``: only the
padding of the last KV chunk is masked).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, wq: L.Dense, wk: L.Dense, wv: L.Dense, wo: L.Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init(gen, cfg, dtype, *, device=None) -> Attention:
    d = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device)
    wq = L.dense_init(gen, d, H * hd, dtype, bias=cfg.qkv_bias, **kw)
    wk = L.dense_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias, **kw)
    wv = L.dense_init(gen, d, KV * hd, dtype, bias=cfg.qkv_bias, **kw)
    wo = L.dense_init(gen, H * hd, d, dtype, **kw)
    return Attention(wq, wk, wv, wo)


def _qkv(p: Attention, cfg, x, positions, dtype):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense_apply(p.wq, x, dtype).reshape(B, S, H, hd)
    k = L.dense_apply(p.wk, x, dtype).reshape(B, S, KV, hd)
    v = L.dense_apply(p.wv, x, dtype).reshape(B, S, KV, hd)
    q, k = L.rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def _pad_seq(t, n: int):
    """Zero-pad dim 1 of ``[B, S, heads, hd]`` by ``n``."""
    return F.pad(t, (0, 0, 0, 0, 0, n)) if n else t


def flash_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    skip_offset: int = 0, partial: bool = False):
    """Online-softmax attention.

    q: [B, Sq, H, hd]; k,v: [B, Sk, KV, hd] (GQA: H % KV == 0).
    q_offset: absolute position of q[0] (causal masking with a cache).
    skip_offset: the position the causal chunk skip counts q[0] at (the
    reference's skip counts from 0 whatever ``q_offset`` is; the model
    axis's query rows pass their offset, so that no chunk they see is
    skipped).
    kv_len: optional [B] valid KV lengths (decode with ragged cache).
    partial: return the float32 running state instead, ``(m, s, acc)``
    ``[B, Sq, G, KV]``, ``[B, Sq, G, KV]`` and ``[B, Sq, G, KV, hd]``
    before the division (one q chunk only): the model axis merges the
    shards' states over their positions (``tensor_parallel``).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    # the reference bounds its q unroll to <= 16 chunks on long sequences
    q_chunk = min(max(q_chunk, -(-Sq // 16)), Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = (Sq + q_chunk - 1) // q_chunk
    nk = (Sk + kv_chunk - 1) // kv_chunk
    dev = q.device
    # pad to whole chunks; [B, nq, qc, KV, G, hd] and [B, nk, kc, KV, hd]
    qp = _pad_seq(q, nq * q_chunk - Sq).reshape(B, nq, q_chunk, KV, G, hd)
    kp = _pad_seq(k, nk * kv_chunk - Sk).reshape(B, nk, kv_chunk, KV, hd)
    vp = _pad_seq(v, nk * kv_chunk - Sk).reshape(B, nk, kv_chunk, KV, hd)
    f32 = torch.float32

    def q_step(qi):
        qc = qp[:, qi].to(f32)                # [B, qc, KV, G, hd]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, G, KV), NEG_INF, dtype=f32, device=dev)
        s = torch.zeros((B, q_chunk, G, KV), dtype=f32, device=dev)
        acc = torch.zeros((B, q_chunk, G, KV, hd), dtype=f32, device=dev)
        # causal chunk skip: kv chunks strictly above the diagonal are
        # fully masked, so they are not computed
        nk_i = min(nk, (skip_offset + qi * q_chunk + q_chunk - 1)
                   // kv_chunk + 1) if causal else nk
        for ki in range(nk_i):
            kc = kp[:, ki].to(f32)            # [B, kc, KV, hd]
            vc = vp[:, ki].to(f32)
            logits = torch.einsum("bqkgh,bckh->bqgkc", qc, kc) * scale
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            valid = (k_pos[None, :] < Sk).expand(q_chunk, kv_chunk)
            if causal:
                valid = valid & (k_pos[None, :] <= q_pos[:, None])
            logits = torch.where(valid[None, :, None, None, :], logits,
                                 NEG_INF)
            if kv_len is not None:
                lv = k_pos[None, :] < kv_len[:, None]   # [B, kc]
                logits = torch.where(lv[:, None, None, None, :], logits,
                                     NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            s = s * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqgkc,bckh->bqgkh", p, vc)
            m = m_new
        return m, s, acc

    if partial:
        if nq != 1:
            raise ValueError(f"a partial state covers one q chunk, not {nq}")
        m, s, acc = q_step(0)
        return m[:, :Sq], s[:, :Sq], acc[:, :Sq]

    def q_out(qi):
        _, s, acc = q_step(qi)
        return acc / torch.clamp_min(s[..., None], 1e-30)  # [B,qc,G,KV,hd]

    outs = torch.stack([q_out(qi) for qi in range(nq)], dim=0)
    # outs: [nq, B, qc, G, KV, hd] -> [B, Sq, H, hd]
    out = outs.permute(1, 0, 2, 4, 3, 5).reshape(B, nq * q_chunk, KV * G,
                                                 hd)[:, :Sq]
    return out.to(q.dtype)


def merge_partials(states):
    """The attention of :func:`flash_attention`'s ``partial`` states over
    disjoint sets of positions, stacked ``[n, B, Sq, G, KV, hd + 2]``
    (``acc``, then ``m`` and ``s``): the running maxima's largest, then
    each set's sum and accumulator scaled to it, added in set order, as
    the online softmax adds its chunks. Returns ``[B, Sq, H, hd]``
    float32."""
    acc, m, s = states[..., :-2], states[..., -2], states[..., -1]
    top = m.amax(dim=0)
    tot_s = tot_acc = None
    for i in range(states.shape[0]):
        w = torch.exp(m[i] - top)
        a, b = acc[i] * w[..., None], s[i] * w
        tot_acc = a if tot_acc is None else tot_acc + a
        tot_s = b if tot_s is None else tot_s + b
    out = tot_acc / torch.clamp_min(tot_s[..., None], 1e-30)
    B, Sq, G, KV, hd = out.shape
    return out.permute(0, 1, 3, 2, 4).reshape(B, Sq, KV * G, hd)


def apply_full(p: Attention, cfg, x, positions, dtype, *, causal=True):
    """Training / prefill path (no cache in, optionally cache out)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, dtype)
    out = flash_attention(q, k, v, causal=causal)
    y = L.dense_apply(p.wo, out.reshape(B, S, -1), dtype)
    return y, (k, v)


def write_kv(cache, new, cache_len, offset: int = 0) -> None:
    """Add ``new`` ``[B, 1, KV, hd]`` into ``cache`` ``[B, Smax, KV, hd]``
    at position ``cache_len[b]`` of each row, in place: the reference's
    one-hot einsum add. A row whose position is past the cache (an idle
    slot keeps advancing) writes nothing, where the one-hot is all zero;
    it neither clamps nor raises. ``offset``: the position of the cache's
    first row (a model shard's range of positions); a row whose position
    lies before it writes nothing either."""
    B, Smax = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    at = cache_len - offset if offset else cache_len
    pos = torch.clamp(at, min=0 if offset else None, max=Smax - 1).long()
    cur = cache[rows, pos]                                 # [B, KV, hd]
    keep = (at < Smax) & (at >= 0) if offset else at < Smax
    keep = keep[:, None, None]
    cache[rows, pos] = torch.where(keep, cur + new[:, 0].to(cache.dtype),
                                   cur)


def apply_decode(p: Attention, cfg, x, cache_k, cache_v, cache_len, dtype):
    """Single-token decode. x: [B, 1, d]; cache: [B, Smax, KV, hd], written
    in place (and returned)."""
    B = x.shape[0]
    positions = cache_len[:, None]            # [B, 1]
    q, k, v = _qkv(p, cfg, x, positions, dtype)
    write_kv(cache_k, k, cache_len)
    write_kv(cache_v, v, cache_len)
    dt = L.as_dtype(dtype)
    out = flash_attention(q, cache_k.to(dt), cache_v.to(dt),
                          causal=False, kv_len=cache_len + 1,
                          q_chunk=1, kv_chunk=4096)
    y = L.dense_apply(p.wo, out.reshape(B, 1, -1), dtype)
    return y, cache_k, cache_v


def cross_kv(p: Attention, cfg, enc_out, dtype):
    """Project the encoder output ``[B, Se, d]`` to K/V ``[B, Se, KV, hd]``
    once (every decode step reuses them); no RoPE."""
    B, S, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = L.dense_apply(p.wk, enc_out, dtype).reshape(B, S, KV, hd)
    v = L.dense_apply(p.wv, enc_out, dtype).reshape(B, S, KV, hd)
    return k, v


def apply_cross(p: Attention, cfg, x, enc_k, enc_v, dtype):
    """Cross-attention of ``x`` ``[B, S, d]`` over the fixed encoder K/V
    (prefill and decode): the query unrotated, the reference's default
    chunks, no causal mask and no ``kv_len``."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = L.dense_apply(p.wq, x, dtype).reshape(B, S, H, hd)
    out = flash_attention(q, enc_k, enc_v, causal=False)
    return L.dense_apply(p.wo, out.reshape(B, S, -1), dtype)
