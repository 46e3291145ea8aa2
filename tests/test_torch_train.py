"""repro_torch's training side against the reference's, on the CPU.

* the synthetic stream: ``markov_table``, ``batch_rows``,
  ``next_host_batch`` and ``state``/``restore``, bit for bit over three
  seeds; ``next_batch`` as tensors on a device;
* E8MY compression: ``e8m_truncate``, ``compress`` and
  ``compressed_psum`` at 7, 10 and 16 mantissa bits, and the u16/u8 wire
  codecs, bit for bit over random values, ±0, subnormals, ±inf, NaN and
  values whose rounding carries into the exponent or out of the top bit;
* AdamW: ``lr_at`` over every step of five schedules, ``global_norm`` in
  the reference's leaf order, ``apply_updates`` on a reduced model's
  tree (m and v bit for bit, the master within ``MASTER_ULPS``);
* checkpoints across packages: the reference's restore in the port and
  the port's in the reference's reader (keys, shapes, dtypes, values),
  atomic commit, keep-k, the missing-leaf and shape errors;
* fault handling: ``PreemptionGuard`` under SIGTERM, in the trainer too
  (it saves and stops); ``StepMonitor``'s events against the reference's
  on one scripted clock;
* the Trainer against the reference's Trainer, run once per module on a
  mesh with Auto axes (the reference's default mesh has Explicit axes
  under JAX 0.9, on which its ``constrain`` raises): 4 steps with
  checkpoints at 2 and 4, the port restoring the reference's step-2
  checkpoint and running to step 4, E8M10 gradient compression for 2
  steps; the port's counterparts of the reference's three trainer tests
  that fail on that mesh (resume, finite losses, microbatch = full
  batch); ``make_prefill_step``/``make_decode_step``; ``launch.train``.

The reduced qwen2-0.5b runs in float32 (its config's compute dtype).
Values are held to ``RTOL`` relative to the largest magnitude where the
two packages' float32 sums differ in order, integers and bits exactly.
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import synthetic as rsyn
from repro.launch import steps as rsteps
from repro.models import transformer as rtfm
from repro.optim import adamw as radamw
from repro.optim import compression as rcomp
from repro.train import checkpoint as rckpt
from repro.train import fault as rfault
from repro.train import trainer as rtrainer
from repro_torch import configs
from repro_torch.data import synthetic as syn
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import trainer as trainer_mod

#: float32 values whose sums run in another order in the two packages,
#: relative to the largest |value| (losses and the master after steps)
RTOL = 1e-5
#: ``apply_updates``' master against the reference's, in float32 ulps of
#: the larger of the element and the rate: with the same gradients m and
#: v are bit-equal (same ops, same order) while the clip scale is 1, but
#: XLA fuses the update ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``
#: into one loop, whose rounding differs from torch's op-by-op one on a
#: few elements in 10^3
MASTER_ULPS = 4
#: the master after trainer steps against the reference's: both packages'
#: gradients differ by float32 rounding, and Adam's normalised step
#: ``m/sqrt(v)`` turns an element whose gradient is near rounding level
#: (the key bias's is zero in exact arithmetic: softmax ignores a shift
#: common to a query's logits) into up to ``lr`` a step either way. So
#: every element within ``2 lr`` per step, and all but ``1e-4`` of them
#: within ``RTOL`` of the leaf's largest |value| (7 of 361,600 past 1e-6
#: absolute after 4 steps, measured)
MASTER_FAR_SHARE = 1e-4
ARCH = "qwen2-0.5b"
#: the learning rates of the 4 trainer steps (warmup 1, 4 steps): an
#: element moves by at most about one rate a step
LR_SUM = 4 * 3e-4


def _cfgs():
    return (configs.reduce(configs.get(ARCH)),
            rconfigs.reduce(rconfigs.get(ARCH)))


def _tree_leaves(tree):
    """``{path: numpy}`` of a nested dict, the reference's leaf order."""
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _master_close(got: dict, want: dict, lr_sum: float,
                  share: float = MASTER_FAR_SHARE):
    """``MASTER_FAR_SHARE``'s rule over every leaf (``share`` in its
    place where an exchange quantises the gradients)."""
    far = total = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * lr_sum, k
        far += int((d > RTOL * np.abs(w).max()).sum())
        total += w.size
    assert far <= share * total, (far, total)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_stream_bit_equal(seed):
    kw = dict(vocab=300, seq_len=24, global_batch=3, seed=seed)
    r = rsyn.SyntheticTokenStream(rsyn.DataConfig(**kw))
    t = syn.SyntheticTokenStream(syn.DataConfig(**kw))
    np.testing.assert_array_equal(syn.markov_table(t.cfg),
                                  rsyn.markov_table(r.cfg))
    for _ in range(2):
        a, b = r.next_host_batch(), t.next_host_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    rows_r, rows_t = r.batch_rows(5, 1, 3), t.batch_rows(5, 1, 3)
    for k in rows_r:
        np.testing.assert_array_equal(rows_r[k], rows_t[k])
    assert t.state() == r.state() == {"step": 2, "seed": seed}
    t2 = syn.SyntheticTokenStream(syn.DataConfig(**kw))
    t2.restore(r.state())
    np.testing.assert_array_equal(t2.next_host_batch()["tokens"],
                                  r.next_host_batch()["tokens"])
    with pytest.raises(AssertionError, match="data seed mismatch"):
        t2.restore({"step": 0, "seed": seed + 1})


def test_next_batch_on_a_device(monkeypatch):
    kw = dict(vocab=50, seq_len=8, global_batch=2, seed=3)
    t = syn.SyntheticTokenStream(syn.DataConfig(**kw))
    want = syn.SyntheticTokenStream(syn.DataConfig(**kw)).next_host_batch()
    got = t.next_batch("cpu")
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.next_batch()


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def _edge_values(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4000)
         * 10.0 ** rng.integers(-40, 38, 4000)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                        -1e-45, 1e-40, -3e-39, 3.4028235e38, -3.4028235e38,
                        1.9999999, -1.9999999, 0.99999994], np.float32)
    # rounding that carries into the exponent, into the sign bit, NaN
    # payloads
    bits = np.array([0x3FFFFFFF, 0x3F7FFFFF, 0x7F7FFFFF, 0x7FFFFFFF,
                     0xFFFFFFFF, 0x00FFFFFF, 0x7FC00001, 0x807FFFFF],
                    np.uint32).view(np.float32)
    return np.concatenate([x, special, bits])


@pytest.mark.parametrize("bits", [7, 10, 16])
def test_e8m_truncate_and_compress_bit_equal(bits):
    x = _edge_values()
    want = np.asarray(rcomp.e8m_truncate(jnp.asarray(x), bits))
    got = comp.e8m_truncate(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    err = np.random.default_rng(1).standard_normal(x.size).astype(
        np.float32) * 1e-3
    g = np.where(np.isfinite(x), x, 0).astype(np.float32) * 1e-30
    wq, we = rcomp.compress(jnp.asarray(g), jnp.asarray(err), bits)
    q, e = comp.compress(torch.from_numpy(g), torch.from_numpy(err), bits)
    np.testing.assert_array_equal(_bits(q.numpy()), _bits(wq))
    np.testing.assert_array_equal(_bits(e.numpy()), _bits(we))


def test_compressed_psum_over_one_shard_bit_equal():
    """The reference's ``compressed_psum`` over an axis of one shard (a
    vmap of size 1) equals the port's, whose sum is the identity."""
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal(s).astype(np.float32) for s in (7, (3, 5))]
    es = [rng.standard_normal(np.shape(g)).astype(np.float32) * 1e-4
          for g in gs]
    ws, we = jax.vmap(lambda g, e: rcomp.compressed_psum(g, e, "d", 10),
                      axis_name="d")([jnp.asarray(g)[None] for g in gs],
                                     [jnp.asarray(e)[None] for e in es])
    got, gote = comp.compressed_psum([torch.from_numpy(g) for g in gs],
                                     [torch.from_numpy(e) for e in es], 10)
    for a, b in zip(got + gote, list(ws) + list(we)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b[0]))


def test_wire_codecs_bit_equal():
    x = _edge_values(3)
    w16 = np.asarray(rcomp._f32_to_u16(jnp.asarray(x)))
    g16 = comp._f32_to_u16(torch.from_numpy(x))
    assert g16.dtype == torch.uint16
    np.testing.assert_array_equal(g16.numpy(), w16)
    np.testing.assert_array_equal(
        _bits(comp._u16_to_f32(g16).numpy()),
        _bits(rcomp._u16_to_f32(jnp.asarray(w16))))
    rng = np.random.default_rng(4)
    y = (rng.standard_normal(3000) * 5).astype(np.float32)
    # in range, past the largest finite byte on both sides, inf and NaN
    y = np.concatenate([y, np.array([448, 464, 465, 470, -470, 1e9, np.inf,
                                     -np.inf, np.nan, 1e-9, -0.0],
                                    np.float32)])
    for scale in (np.float32(1.0), np.float32(np.abs(y[:3000]).max() / 448)):
        w8 = np.asarray(rcomp._f32_to_u8(jnp.asarray(y), jnp.float32(scale)))
        g8 = comp._f32_to_u8(torch.from_numpy(y), torch.tensor(scale))
        assert g8.dtype == torch.uint8
        np.testing.assert_array_equal(g8.numpy(), w8)
        np.testing.assert_array_equal(
            _bits(comp._u8_to_f32(g8, torch.tensor(scale)).numpy()),
            _bits(rcomp._u8_to_f32(jnp.asarray(w8), jnp.float32(scale))))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("warmup,total", [(1, 4), (1, 12), (2, 8), (7, 50),
                                          (200, 10_000)])
def test_lr_at_over_every_step(warmup, total):
    """The warmup bit for bit; on the cosine, the port's cosine within
    one ulp of the reference's float32 cosine and every other op the
    same, so the rate within what that ulp moves it by (``0.5 lr_peak
    (ulp(cos) + ulp(1 + cos))``, the second for the rounding of ``1 +
    cos`` it may flip; near the end of the decay, where ``1 + cos``
    cancels, that is many ulps of the rate) plus one ulp; where the
    cosines agree, bit for bit."""
    ro = radamw.OptConfig(warmup=warmup, total_steps=total)
    po = adamw.OptConfig(warmup=warmup, total_steps=total)
    ss = np.arange(total + 3)
    # one step at a time, op by op (compiled, XLA rewrites the division
    # and the product by pi, and the rate moves by an ulp or two), in
    # float32 as the reference runs (the suite turns on float64, which
    # the schedule's weakly typed floats would take)
    with jax.enable_x64(False):
        want = np.array([radamw.lr_at(ro, jnp.int32(s)) for s in ss],
                        np.float32)
        arg_ref = np.array([np.pi * jnp.clip(
            (jnp.int32(s) - warmup) / max(total - warmup, 1), 0.0, 1.0)
            for s in ss], np.float32)
        cos_ref = np.array([jnp.cos(jnp.float32(a)) for a in arg_ref],
                           np.float32)
    got = adamw.lr_at(po, torch.tensor(ss, dtype=torch.int32)).numpy()
    assert got.dtype == np.float32
    warm = ss < warmup
    np.testing.assert_array_equal(_bits(got[warm]), _bits(want[warm]))
    cos_got = adamw._cos(torch.from_numpy(arg_ref)).numpy()
    assert _ulps(cos_got, cos_ref).max() <= 1
    ulp_cos = np.spacing(np.abs(cos_ref)).astype(np.float64) + np.spacing(
        np.abs(np.float32(1) + cos_ref))
    bound = 0.5 * po.lr_peak * ulp_cos + np.spacing(np.abs(want))
    assert np.all(np.abs(got.astype(np.float64) - want)[~warm]
                  <= bound[~warm])
    same = (_ulps(cos_got, cos_ref) == 0) & ~warm
    np.testing.assert_array_equal(_bits(got[same]), _bits(want[same]))


@pytest.fixture(scope="module")
def tiny():
    cfg, rcfg = _cfgs()
    rp = jax.tree.map(np.asarray, rtfm.init_params(
        rcfg, jax.random.PRNGKey(0))[0])
    return cfg, rcfg, rp


def test_reference_leaf_order_and_global_norm(tiny):
    cfg, _, rp = tiny
    p = tfm.load_reference_params(cfg, rp, device="cpu")
    assert ["/".join(path) for path, _ in tfm.reference_leaves(p)] == \
        list(_tree_leaves(rp))
    rng = np.random.default_rng(5)
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), rp)
    gm = tfm.load_reference_params(cfg, g, device="cpu")
    got = adamw.global_norm([t.detach() for t in gm.parameters()],
                            tfm.reference_groups(gm))
    want = radamw.global_norm(g)
    # per-leaf sums in another order; the leaves added in the reference's
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_apply_updates_against_the_reference(tiny):
    cfg, _, rp = tiny
    rng = np.random.default_rng(6)
    ro = radamw.OptConfig(warmup=2, total_steps=10)
    po = adamw.OptConfig(warmup=2, total_steps=10)
    rs = radamw.init_state(rp)
    st = adamw.init_state(tfm.load_reference_params(cfg, rp, device="cpu"))
    assert all(p.requires_grad for p in st.master.parameters())
    groups = tfm.reference_groups(st.master)
    for _ in range(3):
        # a global norm below clip_norm: the clip scale is exactly 1 in
        # both packages, whatever order their per-leaf sums take
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3)
                         .astype(np.float32), rp)
        rs = radamw.apply_updates(rs, g, ro)
        gm = tfm.load_reference_params(cfg, g, device="cpu")
        st = adamw.apply_updates(st, [t.detach() for t in gm.parameters()],
                                 po, groups)
    assert int(st.step) == int(rs.step) == 3
    assert st.step.dtype == torch.int32
    for name in ("m", "v"):
        got = _tree_leaves(tfm.to_reference_params(getattr(st, name)))
        for k, want in _tree_leaves(getattr(rs, name)).items():
            np.testing.assert_array_equal(_bits(got[k]), _bits(want), k)
    _master_ulps(_tree_leaves(tfm.to_reference_params(st.master)),
                 _tree_leaves(rs.master), po.lr_peak)


def _master_ulps(got: dict, want: dict, lr: float):
    """Each element within ``MASTER_ULPS`` ulps of the larger of its own
    magnitude and the rate (the update's size: near zero, ``p - lr u``
    cancels)."""
    for k, w in want.items():
        size = np.maximum(np.abs(w), np.float32(lr))
        assert np.all(np.abs(got[k] - w) <= MASTER_ULPS * np.spacing(size)), k


def test_apply_updates_clipped(tiny):
    """A global norm past clip_norm: the scale is 1/gnorm, whose last bit
    follows the per-leaf sums' order; m and v within 2 ulps."""
    cfg, _, rp = tiny
    rng = np.random.default_rng(9)
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), rp)
    rs = radamw.apply_updates(radamw.init_state(rp), g, radamw.OptConfig())
    st = adamw.init_state(tfm.load_reference_params(cfg, rp, device="cpu"))
    gm = tfm.load_reference_params(cfg, g, device="cpu")
    st = adamw.apply_updates(st, [t.detach() for t in gm.parameters()],
                             adamw.OptConfig(),
                             tfm.reference_groups(st.master))
    assert float(radamw.global_norm(g)) > 1.0
    for name in ("m", "v"):
        got = _tree_leaves(tfm.to_reference_params(getattr(st, name)))
        for k, want in _tree_leaves(getattr(rs, name)).items():
            assert _ulps(got[k], want).max() <= 2, (name, k)
    _master_ulps(_tree_leaves(tfm.to_reference_params(st.master)),
                 _tree_leaves(rs.master), adamw.OptConfig().lr_peak)


# ---------------------------------------------------------------------------
# fault handling
# ---------------------------------------------------------------------------


def test_preemption_guard_catches_sigterm_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with fault.PreemptionGuard() as guard:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.fired
    assert signal.getsignal(signal.SIGTERM) is prev


def test_step_monitor_events_equal_the_reference(monkeypatch):
    clock = [0.0, 0.1, 0.2, 0.3, 0.4, 0.9, 1.0, 1.6, 1.7, 1.75, 2.0, 3.5,
             3.6, 5.0, 5.1, 5.2]
    out = []
    for mod in (rfault, fault):
        times = iter(clock)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(times))
        mon = mod.StepMonitor(alpha=0.5, threshold=1.5, trip_limit=2,
                              warmup=1)
        evs, trips = [], []
        for i in range(len(clock) // 2):
            mon.start()
            ev = mon.stop(i)
            evs.append(None if ev is None else dataclasses.astuple(ev))
            trips.append(mon.exclusion_recommended)
        out.append((evs, trips, mon.ewma))
    assert out[0] == out[1]
    assert any(e is not None for e in out[0][0]) and any(out[0][1])


# ---------------------------------------------------------------------------
# the Trainer against the reference's
# ---------------------------------------------------------------------------


def _rtcfg(d, **kw):
    a = dict(steps=4, ckpt_dir=str(d), ckpt_every=2, log_every=10,
             seq_len=32, global_batch=2)
    a.update(kw)
    return rtrainer.TrainerConfig(**a)


def _tcfg(d, **kw):
    a = dict(steps=4, ckpt_dir=str(d), ckpt_every=2, log_every=10,
             seq_len=32, global_batch=2)
    a.update(kw)
    return trainer_mod.TrainerConfig(**a)


def _quiet(_):
    pass


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference Trainer's runs, once: 4 steps with checkpoints at 2
    and 4 (its step-2 checkpoint kept aside), and 2 steps with E8M10
    gradient compression."""
    cfg, rcfg = _cfgs()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    root = tmp_path_factory.mktemp("ref")
    opt = radamw.OptConfig(warmup=1, total_steps=4)
    t = rtrainer.Trainer(rcfg, opt, _rtcfg(root / "run"), mesh=mesh,
                         log_fn=_quiet)
    s = t.run()
    shutil.copytree(root / "run", root / "step2")
    shutil.rmtree(root / "step2" / "step_4")
    tc = rtrainer.Trainer(rcfg, radamw.OptConfig(warmup=1, total_steps=2),
                          _rtcfg(root / "comp", steps=2, ckpt_every=100,
                                 grad_compression=10), mesh=mesh,
                          log_fn=_quiet)
    tc.run()
    init = jax.tree.map(np.asarray, rtfm.init_params(
        rcfg, jax.random.PRNGKey(0))[0])
    return dict(root=root, history=t.history, steps=t.ckpt.steps(),
                master=_tree_leaves(s.master), init=init,
                comp=tc.history)


def _port_state(cfg, init):
    return adamw.init_state(tfm.load_reference_params(cfg, init,
                                                      device="cpu"))


def test_trainer_losses_and_checkpoints_match_the_reference(ref, tmp_path):
    cfg, _ = _cfgs()
    t = trainer_mod.Trainer(cfg, adamw.OptConfig(warmup=1, total_steps=4),
                            _tcfg(tmp_path), device="cpu", log_fn=_quiet)
    s = t.run(_port_state(cfg, ref["init"]))
    assert t.ckpt.steps() == ref["steps"] == [2, 4]
    assert [h["step"] for h in t.history] == [1, 2, 3, 4]
    np.testing.assert_allclose([h["loss"] for h in t.history],
                               [h["loss"] for h in ref["history"]],
                               rtol=RTOL)
    _master_close(_tree_leaves(tfm.to_reference_params(s.master)),
                  ref["master"], LR_SUM)
    # the port's checkpoint as the reference's reader sees it
    raw_p, meta_p = rckpt.CheckpointManager(str(tmp_path)).load_raw(4)
    raw_r, meta_r = rckpt.CheckpointManager(
        str(ref["root"] / "run")).load_raw(4)
    assert sorted(raw_p) == sorted(raw_r)
    for k in raw_r:
        assert raw_p[k].dtype == raw_r[k].dtype and \
            raw_p[k].shape == raw_r[k].shape, k
    assert meta_p["extra"] == meta_r["extra"]
    assert meta_p["step"] == 4 and int(raw_p["0"]) == 4
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_port_resumes_the_reference_checkpoint(ref, tmp_path):
    """The reference's step-2 checkpoint restores in the port, which runs
    steps 3 and 4 and ends at the reference's step-4 master."""
    cfg, _ = _cfgs()
    d = tmp_path / "ck"
    shutil.copytree(ref["root"] / "step2", d)
    logs = []
    t = trainer_mod.Trainer(cfg, adamw.OptConfig(warmup=1, total_steps=4),
                            _tcfg(d), device="cpu", log_fn=logs.append)
    s = t.run()
    assert any("restored step 2" in m for m in logs)
    assert int(s.step) == 4 and t.data.state() == {"step": 4, "seed": 0}
    np.testing.assert_allclose([h["loss"] for h in t.history],
                               [h["loss"] for h in ref["history"][2:]],
                               rtol=RTOL)
    _master_close(_tree_leaves(tfm.to_reference_params(s.master)),
                  ref["master"], LR_SUM)


def test_grad_compression_matches_the_reference(ref, tmp_path):
    cfg, _ = _cfgs()
    t = trainer_mod.Trainer(cfg, adamw.OptConfig(warmup=1, total_steps=2),
                            _tcfg(tmp_path, steps=2, ckpt_every=100,
                                  grad_compression=10),
                            device="cpu", log_fn=_quiet)
    t.run(_port_state(cfg, ref["init"]))
    np.testing.assert_allclose([h["loss"] for h in t.history],
                               [h["loss"] for h in ref["comp"]], rtol=RTOL)


# -- the port's counterparts of the reference's TestTrainer ------------------


def test_train_checkpoint_resume(tmp_path):
    cfg, _ = _cfgs()
    opt = adamw.OptConfig(warmup=1, total_steps=4)
    t1 = trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path), device="cpu",
                             log_fn=_quiet)
    s1 = t1.run()
    assert int(s1.step) == 4
    assert t1.ckpt.steps() == [2, 4]
    # resume: restores step 4, no further steps executed
    t2 = trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path), device="cpu",
                             log_fn=_quiet)
    s2 = t2.run()
    assert int(s2.step) == 4 and t2.history == []
    for a, b in zip(s1.master.parameters(), s2.master.parameters()):
        assert torch.equal(a, b)
    # from step 2, the same steps 3 and 4 bit for bit
    shutil.rmtree(tmp_path / "step_4")
    t3 = trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path), device="cpu",
                             log_fn=_quiet)
    s3 = t3.run()
    assert [h["loss"] for h in t3.history] == \
        [h["loss"] for h in t1.history[2:]]
    for name in ("master", "m", "v"):
        for a, b in zip(getattr(s1, name).parameters(),
                        getattr(s3, name).parameters()):
            assert torch.equal(a, b), name


def test_losses_finite_and_stable(tmp_path):
    cfg, _ = _cfgs()
    t = trainer_mod.Trainer(
        cfg, adamw.OptConfig(lr_peak=3e-3, warmup=2, total_steps=8),
        _tcfg(tmp_path, steps=8, ckpt_every=100), device="cpu",
        log_fn=_quiet)
    t.run()
    losses = [h["loss"] for h in t.history]
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0] + 0.1   # not diverging
    t.dump_history(str(tmp_path / "h" / "history.json"))
    assert os.path.isfile(tmp_path / "h" / "history.json")


def test_microbatch_matches_full_batch(tmp_path):
    """Gradient accumulation = exact full-batch mean: same losses, within
    the reference's own rtol of 1e-4."""
    cfg, _ = _cfgs()
    opt = adamw.OptConfig(warmup=1, total_steps=3)
    runs = []
    for d, mb in (("a", None), ("b", 2)):
        t = trainer_mod.Trainer(cfg, opt, _tcfg(
            tmp_path / d, steps=3, ckpt_every=100, global_batch=4,
            microbatch=mb), device="cpu", log_fn=_quiet)
        t.run()
        runs.append(t.history)
    for a, b in zip(*runs):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    for mb in (3, 4):
        with pytest.raises(ValueError, match="must divide"):
            trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path / "c",
                                                global_batch=4,
                                                microbatch=mb),
                                device="cpu", log_fn=_quiet)


def test_preemption_saves_and_stops(tmp_path):
    """SIGTERM during step 1: the trainer finishes it, saves step 1 and
    stops."""
    cfg, _ = _cfgs()
    logs = []

    def log(msg):
        logs.append(msg)
        if msg.startswith("[train]"):
            os.kill(os.getpid(), signal.SIGTERM)

    t = trainer_mod.Trainer(cfg, adamw.OptConfig(warmup=1, total_steps=4),
                            _tcfg(tmp_path, ckpt_every=100), device="cpu",
                            log_fn=log)
    s = t.run()
    assert int(s.step) == 1 and len(t.history) == 1
    assert t.ckpt.steps() == [1]
    assert any("preemption signal" in m for m in logs)


def test_checkpoint_keep_and_errors(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), keep=2)
    leaves = {"0": torch.tensor(3, dtype=torch.int32),
              "1/a/w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    for s in (1, 2, 3):
        m.save(s, leaves, extra={"k": s})
    assert m.steps() == [2, 3] and m.latest_step() == 3
    got, meta = m.restore({k: v.to("meta") for k, v in leaves.items()})
    assert meta["extra"] == {"k": 3}
    for k in leaves:
        assert torch.equal(got[k], leaves[k])
    with pytest.raises(KeyError, match="missing leaf"):
        m.restore({"1/b": torch.empty(2, device="meta")})
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore({"1/a/w": torch.empty(3, 2, device="meta")})
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "none")).load_raw()


def test_trainer_needs_one_shard_and_a_device(monkeypatch, tmp_path):
    """More than one data or model shard needs a process group (or a
    mesh); ``pod_wire`` without pods raises."""
    cfg, _ = _cfgs()
    opt = adamw.OptConfig()
    with pytest.raises(RuntimeError, match="initialised process group"):
        trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path, data_axis=2),
                            device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path, model_axis=2),
                            device="cpu")
    with pytest.raises(ValueError, match="2 pods"):
        steps.make_train_step(cfg, opt, pod_wire="u16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.Trainer(cfg, opt, _tcfg(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", ARCH, "--reduce", "--steps", "1"])


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    t = launch_train.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                           "--steps", "3", "--seq-len", "16",
                           "--global-batch", "2", "--ckpt-every", "2",
                           "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done; checkpoints: [2]" in out
    assert len(t.history) == 3 and all(np.isfinite(h["loss"])
                                       for h in t.history)


def test_prefill_and_decode_steps_match_the_reference(tiny):
    cfg, rcfg, rp = tiny
    p = tfm.load_reference_params(cfg, rp, device="cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 6)).astype(
        np.int32)
    rpre, _ = rsteps.make_prefill_step(rcfg, 16)
    rdec, _ = rsteps.make_decode_step(rcfg)
    wl, wc = rpre(rp, {"tokens": jnp.asarray(toks)})
    wn, _ = rdec(rp, jnp.argmax(wl[:, -1], -1).astype(jnp.int32)[:, None],
                 wc)
    with torch.no_grad():
        gl, gc = steps.make_prefill_step(cfg, 16)(
            p, {"tokens": torch.from_numpy(toks)})
        gn, _ = steps.make_decode_step(cfg)(
            p, torch.argmax(gl[:, -1], -1).to(torch.int32)[:, None], gc)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0,
                               atol=RTOL * np.abs(np.asarray(wl)).max())
    assert gn.dtype == torch.int32 and tuple(gn.shape) == (2, 1)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
