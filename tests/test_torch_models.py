"""repro_torch's LM stack against the reference's, on the CPU.

* the config registry: all ten configs, ``reduce``, ``param_count`` and
  the dry-run cell rule equal; the port's dense models allocate the
  analytic parameter count (within 2 %, as the reference's shape check);
* the layers: rmsnorm, rope, swiglu, the embedding and a biased dense;
* ``flash_attention``: causal and not, ``q_offset``, ``kv_len``, lengths
  that leave padded chunks, GQA;
* ``forward_prefill`` (logits and cache) and a chain of
  ``forward_decode`` steps on reduced qwen2-0.5b (tied head, QKV bias),
  granite-3-2b and yi-6b, the moe family's qwen2-moe-a2.7b (shared
  experts) and dbrx-132b, the vlm family's llava-next-mistral-7b
  (patches through the projector), the ssm family's mamba2-1.3b and the
  hybrid family's zamba2-2.7b (a prompt of 40: three SSD chunks; the
  cache's keys in the reference's order), with the reference's
  parameters carried over by ``load_reference_params`` (the encdec
  family's are in ``test_torch_encdec.py``);
* the vision stub's ``_embed_inputs`` (``io_spec.frontend_lens``), the
  one-copy init (``init_params(..., dtype=cfg.dtype)``) against
  ``cast_params`` bit for bit (the moe router and Mamba2's ``A_log``,
  ``D`` and ``dt_bias`` in float32), decode against a longer prefill,
  and the embedding's out-of-range rule
  (wrap in ``[-V, 0)``, NaN outside ``[-V, V)``) on its own and through
  ``forward_prefill``;
* the KV write of a row whose ``len`` has reached or passed ``max_len``
  (the reference's one-hot add writes nothing there);
* a family neither package knows raises ``ValueError`` in both.

Inputs come from numpy with a seed and go through both packages. The
models run in float32 (the reduced configs' compute dtype): the two
packages' float32 sums differ in order, so values are held within
``RTOL`` relative to the largest magnitude, integers and lengths exactly;
the SSM state a prefill hands to decode to ``SSM_STATE_RTOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import io_spec as rio
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro.models.config import SHAPES as RSHAPES
from repro.models.config import cell_applicable as rcell
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import io_spec
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES, cell_applicable

#: float32 values against the reference's, relative to the largest |value|
RTOL = 1e-5
DENSE = ("qwen2-0.5b", "granite-3-2b", "yi-6b")
MOE_VLM = ("qwen2-moe-a2.7b", "dbrx-132b", "llava-next-mistral-7b")
SSM = ("mamba2-1.3b", "zamba2-2.7b")
ENCDEC = ("seamless-m4t-large-v2",)
#: the SSM state after a prefill: the reference's ``_final_state`` takes
#: exp of the difference of two float32 sums of ``dt·A`` over the prompt,
#: which reach about 450 at S = 40 in the reduced configs (A down to -16,
#: dt about 0.7), where a float32 ulp is 2^-15. Both packages sum in one
#: order, but their inputs to the sums round differently upstream (the
#: matmuls), so the states agree to a few of those ulps: eight, 2^-12
#: (4.7e-5 and 5.2e-5 measured). The part that differs decays within a
#: decode step: every cache tensor after one is held to ``RTOL``
SSM_STATE_RTOL = 2.0 ** -12


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= rtol, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_ids_equal():
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert set(SHAPES) == set(RSHAPES)
    for k, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(RSHAPES[k])


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_config_reduce_and_counts_equal(arch):
    mod_id = arch.replace("-", "_").replace(".", "_")
    for cfg, ref in ((configs.get(arch), rconfigs.get(arch)),
                     (configs.get(mod_id), rconfigs.get(mod_id)),
                     (configs.reduce(configs.get(arch)),
                      rconfigs.reduce(rconfigs.get(arch)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert cfg.vocab_padded == ref.vocab_padded
        assert (cfg.d_inner, cfg.ssm_heads, cfg.sub_quadratic) == \
            (ref.d_inner, ref.ssm_heads, ref.sub_quadratic)
        for name in SHAPES:
            assert cell_applicable(cfg, SHAPES[name]) == \
                rcell(ref, RSHAPES[name])


@pytest.mark.parametrize("arch", DENSE + ("internlm2-20b",) + MOE_VLM + SSM
                         + ENCDEC)
def test_full_config_allocates_the_analytic_count(arch):
    """The published widths, on the meta device (no memory): the
    allocated parameters match ``param_count`` within 2 % (the analytic
    count omits the norms, counts the unpadded vocab, takes the vision
    projector as d², where it is ``STUB_DIM``·d, and leaves out the audio
    projector and ``enc_lnf``)."""
    cfg = configs.get(arch)
    model = tfm.Transformer(cfg, device="meta")
    n = model.param_count()
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.02


@pytest.mark.parametrize("arch", DENSE + MOE_VLM + SSM + ENCDEC)
def test_reduced_model_shapes_equal_reference(arch):
    cfg = configs.reduce(configs.get(arch))
    params, _ = rtfm.init_params(rconfigs.reduce(rconfigs.get(arch)),
                                 jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert tfm.init_params(cfg, 0, device="cpu").param_count() == n_ref


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    p = L.rmsnorm_init(64, torch.float32, device="cpu")
    p.g.copy_(_t(g))
    want = rlayers.rmsnorm_apply({"g": jnp.asarray(g)}, jnp.asarray(x), 1e-5,
                                 jnp.float32)
    _close(L.rmsnorm_apply(p, _t(x), 1e-5, torch.float32), want)


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_equal(theta):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    rq, rk = rlayers.rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                          theta)
    tq, tk = L.rope(_t(q), _t(k), _t(pos), theta)
    _close(tq, rq)
    _close(tk, rk)


def test_swiglu_and_dense_equal():
    rng = np.random.default_rng(2)
    d, ff = 48, 96
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.1
         for n, s in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    p = L.swiglu_init(None, d, ff, torch.float32, device="cpu")
    for n, a in w.items():
        getattr(p, n).w.copy_(_t(a))
    want = rlayers.swiglu_apply({n: {"w": jnp.asarray(a)} for n, a in
                                 w.items()}, jnp.asarray(x), jnp.float32)
    _close(L.swiglu_apply(p, _t(x), torch.float32), want)
    b = rng.standard_normal(ff).astype(np.float32)
    dp = L.dense_init(None, d, ff, torch.float32, bias=True, device="cpu")
    dp.w.copy_(_t(w["wi"]))
    dp.b.copy_(_t(b))
    want = rlayers.dense_apply({"w": jnp.asarray(w["wi"]),
                                "b": jnp.asarray(b)}, jnp.asarray(x),
                               jnp.float32)
    _close(L.dense_apply(dp, _t(x), torch.float32), want)


def test_embedding_equal():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    tok = rng.integers(0, 64, (2, 9)).astype(np.int32)
    p = L.embed_init(None, 64, 16, torch.float32, device="cpu")
    p.w.copy_(_t(w))
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = L.embed_apply(p, _t(tok), dt)
        want = rlayers.embed_apply({"w": jnp.asarray(w)}, jnp.asarray(tok),
                                   rdt)
        assert got.dtype == dt
        # a gather and a cast: the same bits in either order
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(want, np.float32))


#: out-of-range ids for a table of V rows: -1, -V (wrap), -V-1, V (NaN)
def _bad_ids(V):
    return [-1, -V, -V - 1, V, V + 7, -(2 ** 31), 2 ** 31 - 1]


@pytest.mark.parametrize("dt,rdt", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=["float32", "bfloat16"])
def test_embedding_out_of_range_as_reference(dt, rdt):
    """``jnp.take``'s fill mode: ids in ``[-V, 0)`` wrap, any id outside
    ``[-V, V)`` gives a NaN row; one id at a time and mixed in a batch
    with valid ones."""
    rng = np.random.default_rng(13)
    V = 64
    w = rng.standard_normal((V, 16)).astype(np.float32)
    p = L.embed_init(None, V, 16, torch.float32, device="cpu")
    p.w.copy_(_t(w))
    rp = {"w": jnp.asarray(w)}
    bad = _bad_ids(V)
    mixed = np.array([[3, -1, V, 0], [-V - 1, V - 1, -V, 5]], np.int32)
    for tok in [np.array([[t]], np.int32) for t in bad] + [mixed]:
        got = L.embed_apply(p, _t(tok), dt).to(torch.float32).numpy()
        want = np.asarray(rlayers.embed_apply(rp, jnp.asarray(tok), rdt),
                          np.float32)
        np.testing.assert_array_equal(got, want)
    got = L.embed_apply(p, _t(mixed), dt).to(torch.float32).numpy()
    assert np.isnan(got[0, 2]).all() and np.isnan(got[1, 0]).all()
    assert not np.isnan(got[0, 1]).any() and not np.isnan(got[1, 2]).any()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

CASES = [
    # (Sq, Sk, H, KV, causal, q_offset, kv_len, q_chunk, kv_chunk)
    (13, 13, 4, 2, True, 0, None, 4, 5),       # padded q and kv chunks
    (13, 13, 4, 4, False, 0, None, 4, 5),      # no GQA, not causal
    (20, 20, 6, 2, True, 0, None, 512, 1024),  # one chunk each
    (40, 40, 4, 1, True, 0, None, 1, 7),       # the <= 16 q-chunk bound
    (5, 17, 4, 2, True, 12, None, 2, 6),       # a cached prefix: q_offset
    (1, 24, 8, 2, False, 0, (24, 9, 1), 1, 4096),   # decode, ragged cache
    (3, 24, 4, 2, False, 0, (0, 5, 30), 2, 5),      # kv_len 0 and past Sk
]


@pytest.mark.parametrize("case", CASES, ids=[f"c{i}" for i in
                                              range(len(CASES))])
def test_flash_attention_equal(case):
    Sq, Sk, H, KV, causal, q_off, kv_len, qc, kc = case
    B, hd = 3, 16
    rng = np.random.default_rng(Sq * 100 + Sk)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = rattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, kv_len=None if kl is None else jnp.asarray(kl),
        q_chunk=qc, kv_chunk=kc)
    got = attn.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, q_offset=q_off,
        kv_len=None if kl is None else _t(kl), q_chunk=qc, kv_chunk=kc)
    _close(got, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _models(arch, seed=0):
    rcfg = rconfigs.reduce(rconfigs.get(arch))
    cfg = configs.reduce(configs.get(arch))
    rparams, _ = rtfm.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, cfg, tfm.load_reference_params(cfg, tree, "cpu")


def _batch(cfg, rng, B, S):
    """Prompt tokens, and the vision stub's patches ~ N(0, 1)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend_len, io_spec.STUB_DIM)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _caches_close(tc, rc, ssm_rtol=RTOL):
    """The same keys in the same order; every tensor within ``RTOL``
    (``ssm`` within ``ssm_rtol``), ``len`` exactly."""
    assert list(tc) == list(rc)
    for key, v in tc.items():
        want = np.asarray(rc[key])
        assert v.dtype == getattr(torch, str(want.dtype)), key
        if key == "len":
            np.testing.assert_array_equal(v.numpy(), want)
        else:
            _close(v, want, ssm_rtol if key == "ssm" else RTOL)


@pytest.mark.parametrize("arch", DENSE + MOE_VLM + SSM)
def test_prefill_and_decode_chain_equal(arch):
    rcfg, rparams, cfg, params = _models(arch)
    rng = np.random.default_rng(4)
    B, S, MAX = (2, 40, 48) if arch in SSM else (2, 11, 24)
    rbatch, tbatch = _batch(cfg, rng, B, S)
    rl, rc = rtfm.forward_prefill(rcfg, rparams, rbatch, MAX)
    tl, tc = tfm.forward_prefill(cfg, params, tbatch, MAX)
    _close(tl, rl)
    _caches_close(tc, rc, SSM_STATE_RTOL)
    tok = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(4):
        rl, rc = rtfm.forward_decode(rcfg, rparams, jnp.asarray(tok), rc)
        tl, tc = tfm.forward_decode(cfg, params, _t(tok), tc)
        _close(tl, rl)
        _caches_close(tc, rc)
        tok = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)[:, None]
        assert np.array_equal(tok[:, 0], tl[:, -1].argmax(-1).numpy())


@pytest.mark.parametrize("arch", ("granite-3-2b", "qwen2-moe-a2.7b",
                                  "llava-next-mistral-7b"))
def test_out_of_range_tokens_through_prefill(arch):
    """A prompt holding -1, -V, V and -V-1 (V = ``vocab_padded``) runs as
    the reference's: the wrapped ids give its logits, a NaN row gives NaN
    where it gives NaN, and the cache lengths are equal."""
    rcfg, rparams, cfg, params = _models(arch, seed=9)
    rng = np.random.default_rng(9)
    V = cfg.vocab_padded
    rbatch, tbatch = _batch(cfg, rng, 3, 6)
    toks = np.array(tbatch["tokens"].numpy())
    toks[0, 2], toks[1, 0], toks[1, 4] = -1, -V, V - 1
    toks[2, 3] = V
    toks[2, 5] = -V - 1
    rbatch["tokens"], tbatch["tokens"] = jnp.asarray(toks), _t(toks)
    rl, rc = rtfm.forward_prefill(rcfg, rparams, rbatch, 16)
    tl, tc = tfm.forward_prefill(cfg, params, tbatch, 16)
    rl = np.asarray(rl)
    np.testing.assert_array_equal(np.isnan(tl.numpy()), np.isnan(rl))
    assert np.isnan(rl[2]).all() and not np.isnan(rl[:2]).any()
    _close(tl[:2], rl[:2])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(rc["len"]))
    # a decode step on a wrapped id, as the reference's
    tok = np.array([[-1], [-V], [3]], np.int32)
    rl, _ = rtfm.forward_decode(rcfg, rparams, jnp.asarray(tok), rc)
    tl, _ = tfm.forward_decode(cfg, params, _t(tok), tc)
    _close(tl[:2], np.asarray(rl)[:2])


def test_frontend_lens_equal():
    for arch in rconfigs.ARCH_IDS:
        cfg, rcfg = configs.get(arch), rconfigs.get(arch)
        for S in (1, 2, 9, 16, 4096, 5760, 32768):
            assert io_spec.frontend_lens(cfg, S) == \
                rio.frontend_lens(rcfg, S)
    assert io_spec.STUB_DIM == rio.STUB_DIM


@pytest.mark.parametrize("with_labels", [False, True])
def test_vlm_embed_inputs_equal(with_labels):
    """The vision stub: the patches projected and put first; labels and
    mask gain zeros in front; positions run over the whole length."""
    rcfg, rparams, cfg, params = _models("llava-next-mistral-7b", seed=2)
    rng = np.random.default_rng(2)
    B = 2
    fl, tl = io_spec.frontend_lens(cfg, 16)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, tl)).astype(np.int32),
             "patches": rng.standard_normal((B, fl, io_spec.STUB_DIM))
             .astype(np.float32)}
    if with_labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (B, tl)).astype(
            np.int32)
        batch["mask"] = (rng.random((B, tl)) < 0.7).astype(np.int32)
    want = rtfm._embed_inputs(rcfg, rparams,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.float32)
    got = tfm._embed_inputs(cfg, params, {k: _t(v) for k, v in batch.items()},
                            torch.float32)
    assert got[0].shape == (B, fl + tl, cfg.d_model)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        assert (g is None) == (w is None) == (not with_labels)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(KeyError, match="patches"):
        tfm._embed_inputs(cfg, params, {"tokens": _t(batch["tokens"])},
                          torch.float32)


@pytest.mark.parametrize("arch", ("granite-3-2b", "qwen2-moe-a2.7b",
                                  "llava-next-mistral-7b") + SSM + ENCDEC)
def test_one_copy_init_bit_equal_cast(arch):
    """``init_params(cfg, s, dtype=cfg.dtype)`` draws each tensor in
    float32 and casts it: every tensor equals ``cast_params(init_params(
    cfg, s), cfg.dtype)``'s bit for bit, the moe router and Mamba2's
    ``A_log``, ``D`` and ``dt_bias`` in float32."""
    cfg = dataclasses.replace(configs.reduce(configs.get(arch)),
                              dtype="bfloat16")
    once = tfm.init_params(cfg, 11, device="cpu", dtype=cfg.dtype)
    cast = tfm.cast_params(tfm.init_params(cfg, 11, device="cpu"),
                           cfg.dtype)
    a, b = dict(once.named_parameters()), dict(cast.named_parameters())
    assert a.keys() == b.keys()
    for name, t in a.items():
        assert t.dtype == b[name].dtype, name
        want = torch.float32 if name.endswith(
            ("router", "A_log", ".D", "dt_bias")) else torch.bfloat16
        assert t.dtype == want, name
        assert torch.equal(t.view(torch.int16 if t.dtype == torch.bfloat16
                                  else torch.int32),
                           b[name].view(torch.int16 if t.dtype ==
                                        torch.bfloat16 else torch.int32)), \
            name
    assert tfm.cast_params(once, cfg.dtype) is once
    # the default keeps param_dtype
    assert tfm.init_params(cfg, 11, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "llava-next-mistral-7b"))
def test_decode_matches_prefill_continuation_moe_vlm(arch):
    """Token 9 decoded after a prefill of 8 against a prefill of 9. The
    moe config takes ``capacity_factor = E/k``, so cap >= S and the
    prefill drops nothing (a decode step never drops); the vlm config
    prefills its patches first."""
    cfg = configs.reduce(configs.get(arch))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    params = tfm.init_params(cfg, 3, device="cpu")
    rng = np.random.default_rng(3)
    _, b = _batch(cfg, rng, 1, 9)
    toks = b["tokens"]
    b8 = dict(b, tokens=toks[:, :8])
    _, cache = tfm.forward_prefill(cfg, params, b8, 32)
    l9_dec, _ = tfm.forward_decode(cfg, params, toks[:, 8:9], cache)
    l9_pre, _ = tfm.forward_prefill(cfg, params, b, 32)
    np.testing.assert_allclose(l9_dec.numpy(), l9_pre.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("n", [9, 41], ids=["S9_one_chunk", "S41_3chunks"])
def test_decode_matches_prefill_continuation_ssm_hybrid(arch, n):
    """Token n decoded after a prefill of n - 1 against a prefill of n:
    the conv and SSM states the prefill hands over (``_final_state``) and
    the hybrid's attention cache carry the sequence on."""
    cfg = configs.reduce(configs.get(arch))
    params = tfm.init_params(cfg, 3, device="cpu")
    toks = _t(np.random.default_rng(n).integers(0, cfg.vocab, (2, n))
              .astype(np.int32))
    _, cache = tfm.forward_prefill(cfg, params, {"tokens": toks[:, :-1]}, 64)
    l_dec, cache = tfm.forward_decode(cfg, params, toks[:, -1:], cache)
    l_pre, c_pre = tfm.forward_prefill(cfg, params, {"tokens": toks}, 64)
    np.testing.assert_allclose(l_dec.numpy(), l_pre.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(cache["len"].numpy(), [n, n])
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(), c_pre[key].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_tied_head_and_qkv_bias_carried_over():
    rcfg, rparams, cfg, params = _models("qwen2-0.5b", seed=5)
    assert params.head is None and params.blocks[0].attn.wq.b is not None
    np.testing.assert_array_equal(
        params.blocks[1].attn.wv.b.numpy(),
        np.asarray(rparams["blocks"]["attn"]["wv"]["b"][1]))


def test_decode_matches_prefill_continuation():
    """The reference's ``tests/test_models_smoke.py:105`` on the port:
    decoding token 9 after a prefill of 8 gives the logits of a prefill
    of 9 (float32; the reference's tolerance)."""
    cfg = configs.reduce(configs.get("yi-6b"))
    params = tfm.init_params(cfg, 3, device="cpu")
    toks = _t(np.random.default_rng(3).integers(0, cfg.vocab, (1, 9))
              .astype(np.int32))
    _, cache = tfm.forward_prefill(cfg, params, {"tokens": toks[:, :8]}, 16)
    l9_dec, _ = tfm.forward_decode(cfg, params, toks[:, 8:9], cache)
    l9_pre, _ = tfm.forward_prefill(cfg, params, {"tokens": toks}, 16)
    np.testing.assert_allclose(l9_dec.numpy(), l9_pre.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_kv_write_past_max_len_drops():
    """Rows at ``len`` max_len - 1 (the last write), max_len and past it:
    the reference's one-hot add writes nothing at or past the end, and
    attends over the whole cache. Logits and caches as the reference's."""
    rcfg, rparams, cfg, params = _models("granite-3-2b", seed=6)
    rng = np.random.default_rng(6)
    MAX = 8
    toks = rng.integers(0, cfg.vocab, (4, MAX)).astype(np.int32)
    rl, rc = rtfm.forward_prefill(rcfg, rparams,
                                  {"tokens": jnp.asarray(toks)}, MAX)
    _, tc = tfm.forward_prefill(cfg, params, {"tokens": _t(toks)}, MAX)
    lens = np.array([MAX - 1, MAX, MAX + 1, MAX + 40], np.int32)
    rc = dict(rc, len=jnp.asarray(lens))
    tc["len"].copy_(_t(lens))
    before = tc["k"].clone()
    tok = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
    for _ in range(2):
        rl, rc = rtfm.forward_decode(rcfg, rparams, jnp.asarray(tok), rc)
        tl, tc = tfm.forward_decode(cfg, params, _t(tok), tc)
        _close(tl, rl)
        for key in ("k", "v"):
            _close(tc[key], rc[key])
    np.testing.assert_array_equal(tc["len"].numpy(), lens + 2)
    # rows 1-3 never wrote; row 0 wrote its last position once
    assert torch.equal(tc["k"][:, 1:], before[:, 1:])
    assert not torch.equal(tc["k"][:, 0, MAX - 1], before[:, 0, MAX - 1])
    assert torch.equal(tc["k"][:, 0, :MAX - 1], before[:, 0, :MAX - 1])


def test_write_kv_adds_at_len():
    """The one-hot einsum is an add: a position that holds a value gets
    the new K/V added to it, as in the reference."""
    cache = torch.ones((2, 4, 1, 2))
    new = torch.full((2, 1, 1, 2), 2.0)
    attn.write_kv(cache, new, torch.tensor([1, 4], dtype=torch.int32))
    want = torch.ones((2, 4, 1, 2))
    want[0, 1] = 3.0
    assert torch.equal(cache, want)


def test_cast_params_once_same_bits():
    """Weights cast to bfloat16 once give the logits of the float32
    weights cast per call (``dense_apply``'s cast), bit for bit."""
    cfg = dataclasses.replace(configs.reduce(configs.get("granite-3-2b")),
                              dtype="bfloat16")
    p32 = tfm.init_params(cfg, 7, device="cpu")
    p16 = tfm.cast_params(p32, "bfloat16")
    assert p16.dtype == torch.bfloat16 and p32.dtype == torch.float32
    assert tfm.cast_params(p16, torch.bfloat16) is p16
    toks = _t(np.arange(1, 7, dtype=np.int32)[None])
    a, ca = tfm.forward_prefill(cfg, p32, {"tokens": toks}, 12)
    b, cb = tfm.forward_prefill(cfg, p16, {"tokens": toks}, 12)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
    a, _ = tfm.forward_decode(cfg, p32, toks[:, :1], ca)
    b, _ = tfm.forward_decode(cfg, p16, toks[:, :1], cb)
    assert torch.equal(a, b)


def test_padded_vocab_masked():
    cfg = dataclasses.replace(configs.reduce(configs.get("granite-3-2b")),
                              vocab=500)
    params = tfm.init_params(cfg, 8, device="cpu")
    logits, _ = tfm.forward_prefill(
        cfg, params, {"tokens": _t(np.array([[1, 2, 3]], np.int32))}, 8)
    assert logits.shape == (1, 1, 512)
    assert torch.all(logits[..., 500:] == -1e30)
    assert torch.all(logits[..., :500] > -1e29)


def test_unknown_family_raises():
    """A family neither package knows raises ``ValueError`` in both
    packages' ``init_params``, as the reference's ``_block_init`` does;
    the port's ``init_cache`` too."""
    arch = "granite-3-2b"
    rcfg = dataclasses.replace(rconfigs.reduce(rconfigs.get(arch)),
                               family="rnn")
    cfg = dataclasses.replace(configs.reduce(configs.get(arch)),
                              family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="rnn"):
        tfm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        tfm.init_cache(cfg, 2, 16, device="cpu")


def test_default_device_is_the_gpu(monkeypatch):
    cfg = configs.reduce(configs.get("granite-3-2b"))
    if torch.cuda.is_available():       # decide here: simulate its absence
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(cfg, 0)
