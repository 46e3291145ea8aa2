"""repro_torch's encdec family against the reference's, on the CPU.

Reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, d 128, 4
heads over 2 KV heads), float32, with the reference's parameters carried
across by ``load_reference_params``:

* ``cross_kv`` and ``apply_cross`` alone (no RoPE on either side, GQA);
* ``_encode`` (the audio stub's projector, non-causal encoder blocks
  with RoPE on the frame positions, ``enc_lnf``) at 8 frames and at
  1,100: three q-chunks of 512, the last padded, and a second KV chunk
  of 76 valid rows of 1,024;
* ``forward_prefill``: the logits, and the cache with the reference's
  keys in its order (``k, v, len, ek, ev``); then 4 ``forward_decode``
  steps with equal greedy tokens, ``ek``/``ev`` left as they were;
* decode against a prefill one token longer;
* ``init_cache``'s ``enc_len``, the audio stub's ``_embed_inputs``
  (tokens only, as the reference's) and ``launch.serve`` refusing the
  family as the reference's does.

Inputs come from numpy with a seed. Values are held within ``RTOL`` of
the largest magnitude, lengths exactly.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as attn
from repro_torch.models import io_spec
from repro_torch.models import transformer as tfm

ARCH = "seamless-m4t-large-v2"
#: float32 values against the reference's, relative to the largest |value|
RTOL = 1e-5
#: 8 frames: one chunk each way; 1,100: padded q- and KV-chunks
FRAMES = (8, 1100)


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= rtol, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def models():
    rcfg = rconfigs.reduce(rconfigs.get(ARCH))
    cfg = configs.reduce(configs.get(ARCH))
    rparams, _ = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    params = tfm.load_reference_params(
        cfg, jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, rparams, cfg, params


def _batch(cfg, rng, B, S, Se):
    """Decoder tokens and audio-stub frames ~ N(0, 1)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "frames": rng.standard_normal((B, Se, io_spec.STUB_DIM))
             .astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def test_config_is_gqa_and_param_tree(models):
    _, rparams, cfg, params = models
    assert cfg.family == "encdec" and cfg.n_heads > cfg.n_kv_heads
    assert len(params.blocks) == cfg.n_layers
    assert len(params.enc_blocks) == cfg.enc_layers
    assert tuple(params.projector.w.shape) == (io_spec.STUB_DIM, cfg.d_model)
    for b in params.blocks:
        assert b.xattn is not None and b.ln3 is not None and b.moe is None
    for b in params.enc_blocks:
        assert b.xattn is None and b.mlp is not None
    np.testing.assert_array_equal(
        params.blocks[1].xattn.wv.w.numpy(),
        np.asarray(rparams["blocks"]["xattn"]["wv"]["w"][1]))
    np.testing.assert_array_equal(
        params.enc_blocks[1].mlp.wg.w.numpy(),
        np.asarray(rparams["enc_blocks"]["mlp"]["wg"]["w"][1]))


@pytest.mark.parametrize("Se", FRAMES)
@pytest.mark.parametrize("S", [1, 5])
def test_cross_kv_and_apply_cross_equal(models, S, Se):
    """Decoder layer 1's cross-attention: the encoder K/V and the output
    of ``S`` query rows over ``Se`` encoder rows."""
    rcfg, rparams, cfg, params = models
    rx = jax.tree.map(lambda a: a[1], rparams["blocks"]["xattn"])
    px = params.blocks[1].xattn
    rng = np.random.default_rng(S * 1000 + Se)
    enc = rng.standard_normal((2, Se, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    rk, rv = rattn.cross_kv(rx, rcfg, jnp.asarray(enc), jnp.float32)
    tk, tv = attn.cross_kv(px, cfg, _t(enc), torch.float32)
    assert tk.shape == (2, Se, cfg.n_kv_heads, cfg.head_dim)
    _close(tk, rk)
    _close(tv, rv)
    want = rattn.apply_cross(rx, rcfg, jnp.asarray(x), rk, rv, jnp.float32)
    _close(attn.apply_cross(px, cfg, _t(x), tk, tv, torch.float32), want)


@pytest.mark.parametrize("Se", FRAMES)
def test_encode_equal(models, Se):
    rcfg, rparams, cfg, params = models
    rng = np.random.default_rng(Se)
    rbatch, tbatch = _batch(cfg, rng, 2, 3, Se)
    want = rtfm._encode(rcfg, rparams, rbatch, jnp.float32)
    got = tfm._encode(cfg, params, tbatch, torch.float32)
    assert got.shape == (2, Se, cfg.d_model)
    _close(got, want)


def _caches_close(tc, rc):
    """The same keys in the same order; every tensor within ``RTOL``,
    ``len`` exactly."""
    assert list(tc) == list(rc) == ["k", "v", "len", "ek", "ev"]
    for key, v in tc.items():
        want = np.asarray(rc[key])
        assert v.dtype == getattr(torch, str(want.dtype)), key
        if key == "len":
            np.testing.assert_array_equal(v.numpy(), want)
        else:
            _close(v, want)


@pytest.mark.parametrize("Se", FRAMES)
def test_prefill_and_decode_chain_equal(models, Se):
    rcfg, rparams, cfg, params = models
    rng = np.random.default_rng(4 + Se)
    B, S, MAX = 2, 11, 24
    rbatch, tbatch = _batch(cfg, rng, B, S, Se)
    rl, rc = rtfm.forward_prefill(rcfg, rparams, rbatch, MAX)
    tl, tc = tfm.forward_prefill(cfg, params, tbatch, MAX)
    _close(tl, rl)
    _caches_close(tc, rc)
    assert tc["ek"].shape == (cfg.n_layers, B, Se, cfg.n_kv_heads,
                              cfg.head_dim)
    ek, ev = tc["ek"].clone(), tc["ev"].clone()
    tok = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(4):
        rl, rc = rtfm.forward_decode(rcfg, rparams, jnp.asarray(tok), rc)
        tl, tc2 = tfm.forward_decode(cfg, params, _t(tok), tc)
        assert tc2 is tc                  # written in place
        _close(tl, rl)
        _caches_close(tc, rc)
        tok = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], tl[:, -1].argmax(-1).numpy())
    np.testing.assert_array_equal(tc["len"].numpy(), [S + 4] * B)
    assert torch.equal(tc["ek"], ek) and torch.equal(tc["ev"], ev)


@pytest.mark.parametrize("Se", FRAMES)
def test_decode_matches_prefill_continuation(models, Se):
    """Token 9 decoded after a prefill of 8 against a prefill of 9 on the
    same frames (the reference's tolerance for decode against prefill),
    and against the reference's prefill of 9."""
    rcfg, rparams, cfg, params = models
    rng = np.random.default_rng(3 + Se)
    rbatch, b = _batch(cfg, rng, 1, 9, Se)
    toks = b["tokens"]
    _, cache = tfm.forward_prefill(cfg, params, dict(b, tokens=toks[:, :8]),
                                   32)
    l9_dec, _ = tfm.forward_decode(cfg, params, toks[:, 8:9], cache)
    l9_pre, _ = tfm.forward_prefill(cfg, params, b, 32)
    r9_pre, _ = rtfm.forward_prefill(rcfg, rparams, rbatch, 32)
    for want in (l9_pre.numpy(), np.asarray(r9_pre)):
        np.testing.assert_allclose(l9_dec.numpy(), want, rtol=2e-3,
                                   atol=2e-3)
    _close(l9_pre, r9_pre)


def test_init_cache_enc_len_as_reference(models):
    rcfg, _, cfg, _ = models
    for enc_len in (0, 7):
        rc = rtfm.init_cache(rcfg, 3, 16, enc_len)
        tc = tfm.init_cache(cfg, 3, 16, enc_len, device="cpu")
        assert list(tc) == list(rc)
        for key, v in tc.items():
            assert tuple(v.shape) == rc[key].shape, key
            assert v.dtype == getattr(torch, str(rc[key].dtype)), key
            assert not v.any()
    assert list(tfm.init_cache(cfg, 1, 4, device="cpu")) == list(
        rtfm.init_cache(rcfg, 1, 4))


@pytest.mark.parametrize("with_labels", [False, True])
def test_audio_stub_embed_inputs_tokens_only(models, with_labels):
    """The audio stub's frames go to the encoder: ``_embed_inputs`` embeds
    the tokens only, as the reference's, with or without labels."""
    rcfg, rparams, cfg, params = models
    rng = np.random.default_rng(5)
    rbatch, tbatch = _batch(cfg, rng, 2, 6, 8)
    if with_labels:
        lab = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
        mask = (rng.random((2, 6)) < 0.7).astype(np.int32)
        rbatch.update(labels=jnp.asarray(lab), mask=jnp.asarray(mask))
        tbatch.update(labels=_t(lab), mask=_t(mask))
    want = rtfm._embed_inputs(rcfg, rparams, rbatch, jnp.float32)
    got = tfm._embed_inputs(cfg, params, tbatch, torch.float32)
    assert got[0].shape == (2, 6, cfg.d_model)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        assert (g is None) == (w is None) == (not with_labels)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prefill_without_frames_raises_keyerror(models):
    rcfg, rparams, cfg, params = models
    toks = np.arange(1, 5, dtype=np.int32)[None]
    with pytest.raises(KeyError, match="frames"):
        rtfm.forward_prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)}, 8)
    with pytest.raises(KeyError, match="frames"):
        tfm.forward_prefill(cfg, params, {"tokens": _t(toks)}, 8)


def test_launch_serve_refuses_encdec(monkeypatch):
    """Both launchers exit before drawing parameters."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH])
    with pytest.raises(SystemExit, match="enc-dec serving needs encoder"):
        rserve.main()
    with pytest.raises(SystemExit, match="enc-dec serving needs encoder"):
        tserve.main(["--arch", ARCH, "--device", "cpu"])
