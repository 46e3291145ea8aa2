"""repro_torch's LM decode engine against the reference's, on the CPU.

* the reference's ``TestServing`` cases (``tests/test_system.py``) on the
  port: continuous batching drains the queue, greedy decode equals a
  manual prefill + ``forward_decode`` chain, warmup with a precision
  store (auto-selected codec logged, store retile applied), EOS;
* the same requests through both engines, with the reference's
  parameters carried over, give the same greedy tokens, the same
  ``serving.*`` series, and ``stats()`` with the same keys; an idle slot
  whose ``len`` runs past ``max_len`` changes nothing;
* the moe family (reduced qwen2-moe-a2.7b and dbrx-132b) through both
  engines: the same greedy tokens and series; a prompt holding
  out-of-range ids (-1, -V, V, -V-1; V = ``vocab_padded``) gives the
  reference engine's tokens on both families; a vlm config fails at its
  first prefill with the reference's ``KeyError`` on ``'patches'``; an
  encdec config (its pool cache has no encoder positions) fails at
  ``warmup()`` with the reference's ``ZeroDivisionError`` and at its first
  prefill with its ``KeyError`` on ``'frames'``;
* the ssm and hybrid families (reduced mamba2-1.3b and zamba2-2.7b)
  through both engines: the same greedy tokens and series; a slot reused
  after a longer request holds the new prompt's conv and SSM states only
  (the earlier request leaves nothing behind);
* the port's own rules: warmup captures the decode step and leaves the
  pool as it found it, the step buffers are written in place, parameters
  already in the compute dtype are not copied, and temperature sampling
  is deterministic per seed.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtfm
from repro.observe import metrics as robs
from repro.serving import DecodeEngine as RefEngine
from repro.serving import ServeConfig as RefServeConfig
from repro_torch import configs
from repro_torch.models import transformer as tfm
from repro_torch.models.sparse_linear import PackSELLLinear
from repro_torch.observe import metrics as tobs
from repro_torch.precision import PrecisionStore
from repro_torch.serving import DecodeEngine, ServeConfig, WarmupSpec
from repro_torch.serving import engine as eng_mod

ARCH = "qwen2-0.5b"          # the reference's ``tiny_cfg()``
MOE = ("qwen2-moe-a2.7b", "dbrx-132b")
SSM = ("mamba2-1.3b", "zamba2-2.7b")


def _load(arch):
    rcfg = rconfigs.reduce(rconfigs.get(arch))
    rparams, _ = rtfm.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = configs.reduce(configs.get(arch))
    params = tfm.load_reference_params(
        cfg, jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, rparams, cfg, params


@pytest.fixture(scope="module")
def models():
    return _load(ARCH)


@pytest.fixture(scope="module", params=MOE)
def moe_models(request):
    return _load(request.param)


@pytest.fixture(scope="module", params=SSM)
def ssm_models(request):
    return _load(request.param)


def _engine(models, **kw):
    _, _, cfg, params = models
    return DecodeEngine(cfg, params, ServeConfig(**kw), device="cpu")


def _requests(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab, size=int(rng.integers(3, 9))),
             int(rng.integers(2, 7))) for _ in range(n)]


# ---------------------------------------------------------------------------
# the reference's TestServing cases, on the port
# ---------------------------------------------------------------------------


def test_continuous_batching_drains_queue(models):
    cfg = models[2]
    eng = _engine(models, slots=2, max_len=48)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=5), max_new_tokens=4)
            for _ in range(5)]
    done = eng.run()
    assert len(done) == 5
    for r in reqs:
        assert len(r.out_tokens) == 4
        assert r.t_done >= r.t_first >= r.t_submit


def test_greedy_matches_manual_decode(models):
    """Engine greedy decode == prefill + manual forward_decode chain."""
    _, _, cfg, params = models
    prompt = np.arange(1, 7, dtype=np.int32)
    eng = _engine(models, slots=1, max_len=32)
    eng.submit(prompt, max_new_tokens=3)
    got = eng.run()[0].out_tokens

    logits, cache = tfm.forward_prefill(
        cfg, params, {"tokens": torch.from_numpy(prompt[None, :])}, 32)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(2):
        tok = torch.tensor([[want[-1]]], dtype=torch.int32)
        logits, cache = tfm.forward_decode(cfg, params, tok, cache)
        want.append(int(torch.argmax(logits[0, -1])))
    assert got == want


def test_warmup_with_precision_store(models, tmp_path, caplog):
    """warmup(precision_store=...) logs auto-selected layer codecs and
    restores (sb, wb) retile winners into the layer plans."""
    eng = _engine(models, slots=1, max_len=32)
    w = np.random.default_rng(0).standard_normal((48, 32)).astype(np.float32)
    path = str(tmp_path / "prec.json")
    lin = PackSELLLinear.from_dense(w, density=0.4, codec="auto",
                                    error_budget=1e-3, store=path, C=8,
                                    sigma=32, device="cpu")
    st = PrecisionStore(path)
    tiles = [(4, 16)] * len(lin.plan.tiles)
    st.put_retile(lin.fingerprint, f"plan_{lin.mat.codec_name}{lin.mat.D}",
                  tiles, backend="cpu")
    with caplog.at_level(logging.INFO, logger="repro_torch.serving.engine"):
        eng.warmup(sparse_layers=[lin], precision_store=path)
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "auto-selected" in msgs
    assert "retiled from store" in msgs
    assert lin.plan.tiles == tuple(tiles)


def test_eos_terminates(models):
    eng0 = _engine(models, slots=1, max_len=32)
    eng0.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=1)
    first = eng0.run()[0].out_tokens[0]
    eng = _engine(models, slots=1, max_len=32, eos_id=first)
    req = eng.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=8)
    eng.run()
    assert req.out_tokens[-1] == first
    assert len(req.out_tokens) == 1


# ---------------------------------------------------------------------------
# both engines on the same requests
# ---------------------------------------------------------------------------


def _serve(make, submit, reqs, obs):
    prev = obs.enable(True)
    obs.reset()
    try:
        eng = make()
        handles = [submit(eng, p, n) for p, n in reqs]
        eng.run()
        snap = obs.snapshot()
    finally:
        obs.reset()
        obs.enable(prev)
    series = {k: v for k, v in snap["counters"].items()
              if k.startswith("serving.")}
    counts = {k: v["count"] for k, v in snap["histograms"].items()
              if k.startswith("serving.")}
    return ([list(h.out_tokens) for h in handles], series, counts,
            eng.stats())


@pytest.mark.parametrize("slots,max_len,n", [(2, 48, 5), (3, 24, 7),
                                             (1, 16, 3)])
def test_same_greedy_tokens_series_and_stats(models, slots, max_len, n):
    rcfg, rparams, cfg, params = models
    reqs = _requests(cfg, n, seed=slots)
    want = _serve(lambda: RefEngine(rcfg, rparams, RefServeConfig(
        slots=slots, max_len=max_len)), lambda e, p, k: e.submit(p, k),
        reqs, robs)
    got = _serve(lambda: DecodeEngine(cfg, params, ServeConfig(
        slots=slots, max_len=max_len), device="cpu"),
        lambda e, p, k: e.submit(p, k), reqs, tobs)
    assert got[0] == want[0]
    assert [len(t) for t in got[0]] == [k for _, k in reqs]
    assert got[1] == want[1] and got[1]["serving.finished"] == n
    assert got[2] == want[2] == {"serving.request_latency_s": n}
    assert set(got[3]) == set(want[3])
    assert got[3]["requests"] == want[3]["requests"]
    assert got[3]["tokens"] == want[3]["tokens"]


@pytest.mark.parametrize("slots,max_len,n", [(2, 48, 5), (3, 24, 6)])
def test_moe_same_greedy_tokens_and_series(moe_models, slots, max_len, n):
    """The moe family through both engines: prefills at the published
    capacity factor (prompts of 3-8 tokens may drop assignments), decode
    ticks that drop none."""
    rcfg, rparams, cfg, params = moe_models
    reqs = _requests(cfg, n, seed=10 + slots)
    want = _serve(lambda: RefEngine(rcfg, rparams, RefServeConfig(
        slots=slots, max_len=max_len)), lambda e, p, k: e.submit(p, k),
        reqs, robs)
    got = _serve(lambda: DecodeEngine(cfg, params, ServeConfig(
        slots=slots, max_len=max_len), device="cpu"),
        lambda e, p, k: e.submit(p, k), reqs, tobs)
    assert got[0] == want[0]
    assert [len(t) for t in got[0]] == [k for _, k in reqs]
    assert got[1] == want[1] and got[2] == want[2]
    assert got[3]["tokens"] == want[3]["tokens"]


@pytest.mark.parametrize("slots,max_len,n", [(2, 48, 5), (3, 64, 6)])
def test_ssm_same_greedy_tokens_and_series(ssm_models, slots, max_len, n):
    """The ssm and hybrid families through both engines, prompts of 3-8
    tokens and, in the second case, one of 37 (three SSD chunks)."""
    rcfg, rparams, cfg, params = ssm_models
    reqs = _requests(cfg, n, seed=20 + slots)
    if slots == 3:
        reqs[2] = (np.random.default_rng(5).integers(1, cfg.vocab, size=37),
                   4)
    want = _serve(lambda: RefEngine(rcfg, rparams, RefServeConfig(
        slots=slots, max_len=max_len)), lambda e, p, k: e.submit(p, k),
        reqs, robs)
    got = _serve(lambda: DecodeEngine(cfg, params, ServeConfig(
        slots=slots, max_len=max_len), device="cpu"),
        lambda e, p, k: e.submit(p, k), reqs, tobs)
    assert got[0] == want[0]
    assert [len(t) for t in got[0]] == [k for _, k in reqs]
    assert got[1] == want[1] and got[2] == want[2]
    assert got[3]["tokens"] == want[3]["tokens"]


def test_reused_slot_keeps_no_state_of_the_last_request(ssm_models):
    """One slot: a request of 30 tokens, then one of 3. After the second
    prefill the slot's conv and SSM states (and the hybrid's K/V rows) are
    the short prompt's own prefill cache, bit for bit, and its tokens are
    those of an engine that served it alone."""
    _, _, cfg, params = ssm_models
    rng = np.random.default_rng(8)
    long, short = rng.integers(1, cfg.vocab, size=30), np.array([4, 9, 2])
    eng = DecodeEngine(cfg, params, ServeConfig(slots=1, max_len=40),
                       device="cpu")
    eng.submit(long, 5)
    eng.run()
    assert any(torch.any(v != 0) for k, v in eng.cache.items())
    req = eng.submit(short, 1)          # finishes at its prefill
    eng.run()
    _, want = tfm.forward_prefill(cfg, eng.params,
                                  {"tokens": torch.from_numpy(short[None])},
                                  40)
    assert list(eng.cache) == list(want)
    for k, v in want.items():
        assert torch.equal(eng.cache[k], v), k
    alone = DecodeEngine(cfg, params, ServeConfig(slots=1, max_len=40),
                         device="cpu")
    eng.submit(short, 6)
    alone.submit(short, 6)
    assert eng.run()[-1].out_tokens == alone.run()[-1].out_tokens
    assert req.out_tokens == alone.done[0].out_tokens[:1]


def _out_of_range_prompts(m):
    """Prompts holding -1, -V (wrapped) and V, -V-1 (a NaN row, so NaN
    logits; argmax picks the first NaN, id 0, in both packages) beside
    valid prompts: every request's greedy tokens are the reference
    engine's, and the engine goes on serving."""
    rcfg, rparams, cfg, params = m
    V = cfg.vocab_padded
    reqs = [(np.array([5, -1, 7, -V], np.int32), 4),
            (np.array([3, 4, V, 6], np.int32), 3),
            (np.array([-V - 1, 2], np.int32), 3),
            (np.arange(1, 6, dtype=np.int32), 4)]
    ref = RefEngine(rcfg, rparams, RefServeConfig(slots=2, max_len=24))
    port = DecodeEngine(cfg, params, ServeConfig(slots=2, max_len=24),
                        device="cpu")
    want = [ref.submit(p, k) for p, k in reqs]
    got = [port.submit(p, k) for p, k in reqs]
    ref.run()
    port.run()
    assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    assert got[1].out_tokens[0] == 0 and got[2].out_tokens[0] == 0


def test_out_of_range_prompt_tokens_as_reference(models):
    _out_of_range_prompts(models)


def test_out_of_range_prompt_tokens_as_reference_moe(moe_models):
    _out_of_range_prompts(moe_models)


def test_vlm_fails_at_first_prefill_as_reference():
    """The engine prefills tokens only; the vision stub reads
    ``batch["patches"]``: both engines raise ``KeyError('patches')`` at
    the first prefill, after the decode step itself ran."""
    rcfg, rparams, cfg, params = _load("llava-next-mistral-7b")
    ref = RefEngine(rcfg, rparams, RefServeConfig(slots=1, max_len=16))
    port = DecodeEngine(cfg, params, ServeConfig(slots=1, max_len=16),
                        device="cpu")
    port.warmup()                       # the decode step runs
    for eng in (ref, port):
        eng.submit(np.arange(1, 5, dtype=np.int32), 2)
        with pytest.raises(KeyError, match="patches"):
            eng.run()


def test_params_in_the_compute_dtype_are_not_copied():
    import dataclasses

    cfg = dataclasses.replace(configs.reduce(configs.get("qwen2-moe-a2.7b")),
                              dtype="bfloat16")
    once = tfm.init_params(cfg, 0, device="cpu", dtype=cfg.dtype)
    eng = DecodeEngine(cfg, once, ServeConfig(slots=1, max_len=16),
                       device="cpu")
    assert eng.params is once
    p32 = tfm.init_params(cfg, 0, device="cpu")
    eng32 = DecodeEngine(cfg, p32, ServeConfig(slots=1, max_len=16),
                         device="cpu")
    assert eng32.params is not p32
    assert eng32.params.blocks[0].moe.router.dtype == torch.float32
    for e in (eng, eng32):
        e.submit(np.arange(1, 5, dtype=np.int32), 3)
    assert eng.run()[0].out_tokens == eng32.run()[0].out_tokens


def test_idle_slot_past_max_len(models):
    """Slot 0 finishes early and idles while slot 1 decodes on: slot 0's
    ``len`` passes ``max_len`` (the KV write drops, no error), and the
    tokens are the reference's."""
    rcfg, rparams, cfg, params = models
    MAX = 16
    reqs = [(np.arange(1, 13, dtype=np.int32), 3),
            (np.arange(5, 7, dtype=np.int32), 14)]
    ref = RefEngine(rcfg, rparams, RefServeConfig(slots=2, max_len=MAX))
    port = DecodeEngine(cfg, params, ServeConfig(slots=2, max_len=MAX),
                        device="cpu")
    want = [ref.submit(p, k) for p, k in reqs]
    got = [port.submit(p, k) for p, k in reqs]
    ref.run()
    port.run()
    assert [g.out_tokens for g in got] == [w.out_tokens for w in want]
    assert int(port.cache["len"][0]) > MAX
    np.testing.assert_array_equal(port.cache["len"].numpy(),
                                  np.asarray(ref.cache["len"]))


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_warmup_leaves_the_pool_as_found(models):
    cfg = models[2]
    eng = _engine(models, slots=2, max_len=24)
    bufs = {k: v.data_ptr() for k, v in eng.cache.items()}
    eng.warmup(WarmupSpec(prompt_lens=(3, 5)))
    assert eng._decode.out is not None          # the step ran once
    for v in eng.cache.values():
        assert not torch.any(v != 0)
    assert not torch.any(eng.tokens != 0)
    reqs = _requests(cfg, 3, seed=9)
    cold = _engine(models, slots=2, max_len=24)
    for e in (eng, cold):
        for p, k in reqs:
            e.submit(p, k)
        e.run()
    assert [r.out_tokens for r in eng.done] == \
        [r.out_tokens for r in cold.done]
    # the step's buffers are the ones the graph was made over
    assert {k: v.data_ptr() for k, v in eng.cache.items()} == bufs


def test_warmup_keyword_and_spec_forms(models):
    eng = _engine(models, slots=1, max_len=16)
    eng.warmup([4, 6])
    with pytest.raises(ValueError, match="not both"):
        eng.warmup(WarmupSpec(), prompt_lens=(4,))
    with pytest.raises(ValueError, match="not both"):
        eng.warmup([4], prompt_lens=(4,))


def test_state_round_trip_and_tick(models):
    """A tick from a saved state twice gives the same logits and the same
    cache: the step is a function of its buffers."""
    eng = _engine(models, slots=2, max_len=24)
    for p, k in _requests(models[2], 2, seed=4):
        eng.submit(p, k + 3)
    eng.step()
    saved = eng.state()
    a = eng.tick().clone()
    after = eng.state()
    eng.set_state(saved)
    b = eng.tick().clone()
    assert torch.equal(a, b)
    for k, v in eng.state().items():
        assert torch.equal(v, after[k])
    assert torch.equal(after["len"], saved["len"] + 1)


@pytest.mark.parametrize("seed", [3, 11])
def test_temperature_sampling_deterministic_per_seed(models, seed):
    cfg = models[2]
    reqs = _requests(cfg, 4, seed=1)

    def run(s):
        eng = _engine(models, slots=2, max_len=32, temperature=1.0, seed=s)
        for p, k in reqs:
            eng.submit(p, k + 4)
        return [r.out_tokens for r in eng.run()]

    a, b, c = run(seed), run(seed), run(seed + 1)
    assert a == b
    assert a != c
    assert all(0 <= t < cfg.vocab for toks in a for t in toks)


def test_encdec_fails_at_warmup_and_first_prefill_as_reference():
    """The engine builds an encdec pool cache with ``enc_len`` 0 and
    prefills tokens only: both engines raise ``ZeroDivisionError`` at
    ``warmup()`` (cross-attention over no encoder position) and
    ``KeyError('frames')`` at the first prefill."""
    rcfg, rparams, cfg, params = _load("seamless-m4t-large-v2")
    ref = RefEngine(rcfg, rparams, RefServeConfig(slots=2, max_len=16))
    port = DecodeEngine(cfg, params, ServeConfig(slots=2, max_len=16),
                        device="cpu")
    assert list(port.cache) == list(ref.cache)
    for key, v in port.cache.items():
        assert tuple(v.shape) == ref.cache[key].shape, key
    assert port.cache["ek"].shape[2] == 0
    for eng in (ref, port):
        with pytest.raises(ZeroDivisionError):
            eng.warmup()
        eng.submit(np.arange(1, 5, dtype=np.int32), 2)
        with pytest.raises(KeyError, match="frames"):
            eng.run()


def test_exporter_lifecycle(models, tmp_path):
    path = tmp_path / "serving.jsonl"
    with _engine(models, slots=1, max_len=16) as eng:
        exp = eng.start_metrics_exporter(str(path), interval_s=60.0)
        assert eng.start_metrics_exporter(str(path)) is exp
        eng.submit(np.arange(1, 4, dtype=np.int32), 2)
        eng.run()
    assert eng._exporter is None
    assert path.exists() and path.read_text().strip()
    assert isinstance(eng.metrics_endpoint_text(), str)


def test_bucket():
    assert [eng_mod._bucket(n) for n in (1, 8, 9, 17, 64)] == \
        [8, 8, 16, 32, 64]
