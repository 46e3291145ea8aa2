"""repro_torch's Mamba2 block (``models.ssm``) against the reference's, on
the CPU.

* ``init``'s leaves against the reference's ``ssm.init``: names, shapes,
  dtypes; ``A_log``, ``D`` and ``dt_bias`` float32 in a bfloat16 model
  after ``cast_params`` and after the one-copy init;
* ``_causal_conv`` without and with a state at S = 1, 2 and 40 (the new
  state of a prompt shorter than K-1 keeps rows of the old one);
* ``_ssd_chunked`` and ``_final_state`` at S = 1, 16 and 40 (S < Q,
  S = Q, three chunks with 8 padded), and the order in which
  ``_final_state`` sums (``_cumsum``, ``_sum``);
* ``apply_full``, ``apply_decode`` and a prefill of 40 followed by 4
  decode steps, on the reference's parameters; the same sequence against
  an independent float64 loop over tokens (``h <- exp(dt A) h + dt B x``,
  ``y = C h + D x``), which checks the chunked algorithm itself;
* the gated norm in bfloat16, bit for bit with the reference's rounding
  order (``ssm.py:161-164``), which ``layers.rmsnorm_apply`` does not
  keep; a whole bfloat16 layer against the reference's within a stated
  tolerance (``F.silu`` and ``jax.nn.silu`` round differently);
* the decode step reads nothing back to the host.

Inputs come from numpy with a seed and go through both packages; values
are held relative to the largest magnitude of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm

#: float32 values against the reference's, relative to the largest |value|
RTOL = 1e-5
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


def _err(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.astype(np.float64) - want).max()) / scale


def _close(got, want, rtol=RTOL):
    err = _err(got, want)
    assert err <= rtol, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs():
    """The reduced mamba2-1.3b; the reduced zamba2-2.7b's Mamba2 has the
    same widths."""
    return (rconfigs.reduce(rconfigs.get("mamba2-1.3b")),
            configs.reduce(configs.get("mamba2-1.3b")))


def _layer(seed=0):
    """The reference's Mamba2 parameters and the port's holding them."""
    rcfg, cfg = _cfgs()
    rp, _ = rssm.init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    p = ssm.init(None, cfg, torch.float32, device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(_t(np.asarray(rp[name], np.float32)))
    return rcfg, rp, cfg, p


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ssm_inputs(cfg, S, seed, B=2):
    """xh, dt (softplus of N(0, 1)), Bc, Cc and the reference's A."""
    rng = np.random.default_rng(seed)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = _x(rng, B, S, H, P)
    dt = np.logaddexp(_x(rng, B, S, H), 0).astype(np.float32)
    Bc, Cc = _x(rng, B, S, N), _x(rng, B, S, N)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    return xh, dt, Bc, Cc, A


def _exp_tol(dt, A) -> float:
    """What the SSD's float32 formulas can be held to against float64: they
    take exp of differences of float32 (cumulative) sums of ``dt·A``, whose
    magnitude reaches ``S·max|dt·A|``; an ulp there moves the exponential by
    that much relative. Eight of those ulps, at least ``RTOL``."""
    top = float(np.abs(np.asarray(dt, np.float64) * A).sum(axis=1).max())
    return max(RTOL, 8 * float(np.spacing(np.float32(top))))


def _recurrence64(xh, dt, Bc, Cc, A, D, h=None):
    """The SSM token by token in float64: ``h <- exp(dt A) h + dt B x``,
    ``y = C h + D x``. Returns y ``[B, S, H, P]`` and the last h
    ``[B, H, N, P]``."""
    xh, dt, Bc, Cc = (np.asarray(a, np.float64) for a in (xh, dt, Bc, Cc))
    A, D = np.asarray(A, np.float64), np.asarray(D, np.float64)
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    h = np.zeros((B, H, N, P)) if h is None else np.asarray(h, np.float64)
    ys = []
    for s in range(S):
        h = np.exp(dt[:, s] * A)[:, :, None, None] * h + \
            dt[:, s, :, None, None] * Bc[:, s, None, :, None] \
            * xh[:, s, :, None, :]
        ys.append(np.einsum("bn,bhnp->bhp", Cc[:, s], h)
                  + D[None, :, None] * xh[:, s])
    return np.stack(ys, 1), h


def _layer64(p, cfg, x, state=None):
    """The whole Mamba2 layer token by token in float64 (the reference's
    ``apply_decode`` applied to each token): x ``[B, S, d]`` -> y, and the
    conv and SSM states after it."""
    w = {n: t.detach().double().numpy() for n, t in p.named_parameters()}
    B, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    K = cfg.ssm_conv
    conv = np.zeros((B, K - 1, di + 2 * N)) if state is None else state[0]
    h = np.zeros((B, H, N, P)) if state is None else state[1]
    A = -np.exp(w["A_log"])
    ys = []
    for s in range(S):
        zxbcdt = np.asarray(x[:, s], np.float64) @ w["in_proj"]
        z, xbc, dtr = (zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N],
                       zxbcdt[:, 2 * di + 2 * N:])
        win = np.concatenate([conv, xbc[:, None]], 1)          # [B, K, ch]
        conv = win[:, 1:]
        c = (win * w["conv_w"][None]).sum(1) + w["conv_b"]
        c = c / (1 + np.exp(-c))
        xh = c[:, :di].reshape(B, 1, H, P)
        y, h = _recurrence64(xh, np.logaddexp(dtr + w["dt_bias"], 0)[:, None],
                             c[:, None, di:di + N], c[:, None, di + N:], A,
                             w["D"], h)
        y = y.reshape(B, di) * (z / (1 + np.exp(-z)))
        y = y / np.sqrt(np.mean(y * y, -1, keepdims=True) + cfg.norm_eps)
        ys.append((y * w["norm_g"]) @ w["out_proj"])
    return np.stack(ys, 1), conv, h


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_init_leaves_as_reference():
    rcfg, cfg = _cfgs()
    rp, _ = rssm.init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = ssm.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                 device="cpu")
    got = dict(p.named_parameters())
    assert set(got) == set(rp)
    for name, a in rp.items():
        assert tuple(got[name].shape) == a.shape, name
    # the deterministic leaves
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_g"):
        _close(got[name], rp[name])
    assert float(got["conv_w"].abs().max()) <= 0.5 / cfg.ssm_conv


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_leaves_stay_float32(arch):
    """``A_log``, ``D`` and ``dt_bias`` stay float32 in a bfloat16 model,
    after ``cast_params`` and after the one-copy init, which agree bit for
    bit; every other Mamba2 tensor is bfloat16."""
    cfg = dataclasses.replace(configs.reduce(configs.get(arch)),
                              dtype="bfloat16")
    cast = tfm.cast_params(tfm.init_params(cfg, 5, device="cpu"), cfg.dtype)
    once = tfm.init_params(cfg, 5, device="cpu", dtype=cfg.dtype)
    for model in (cast, once):
        for name, t in model.blocks[1].ssm.named_parameters():
            want = (torch.float32 if name in ("A_log", "D", "dt_bias")
                    else torch.bfloat16)
            assert t.dtype == want, name
    for (n, a), (_, b) in zip(cast.named_parameters(),
                              once.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 40])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_as_reference(S, with_state):
    rng = np.random.default_rng(S)
    K, ch, B = 4, 24, 3
    xbc, w, b = _x(rng, B, S, ch), _x(rng, K, ch), _x(rng, ch)
    st = _x(rng, B, K - 1, ch) if with_state else None
    ry, rs = rssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                               jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    ty, ts = ssm._causal_conv(_t(xbc), _t(w), _t(b),
                              None if st is None else _t(st))
    _close(ty, ry)
    # the new state is rows of the input: exactly the reference's
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    if with_state and S < K - 1:
        np.testing.assert_array_equal(ts[:, :K - 1 - S].numpy(),
                                      st[:, S:])


@pytest.mark.parametrize("S", [1, 16, 40], ids=["S1_lt_Q", "S16_eq_Q",
                                                "S40_3chunks"])
def test_ssd_chunked_and_final_state(S):
    """Against the reference on the same float32 inputs (``RTOL``), and
    against the float64 loop over tokens: y to ``RTOL``, the final state
    to ``_exp_tol``."""
    rcfg, cfg = _cfgs()
    assert cfg.ssm_chunk == 16
    xh, dt, Bc, Cc, A = _ssm_inputs(cfg, S, seed=S)
    ry = rssm._ssd_chunked(rcfg, *(jnp.asarray(a) for a in
                                   (xh, dt, Bc, Cc, A)))
    rh = rssm._final_state(rcfg, *(jnp.asarray(a) for a in (xh, dt, Bc, A)))
    ty = ssm._ssd_chunked(cfg, *(_t(a) for a in (xh, dt, Bc, Cc, A)))
    th = ssm._final_state(cfg, *(_t(a) for a in (xh, dt, Bc, A)))
    _close(ty, ry)
    _close(th, rh)
    y64, h64 = _recurrence64(xh, dt, Bc, Cc, A, np.zeros(len(A)))
    _close(ty, y64)
    _close(th, h64, _exp_tol(dt, A))


@pytest.mark.parametrize("S", [1, 15, 16, 17, 40, 300, 1000])
def test_sums_in_the_reference_order(S):
    """``_cumsum`` and ``_sum`` give ``jnp.cumsum``'s and ``jnp.sum``'s
    float32 bits, which ``_final_state``'s difference of the two keeps."""
    da = -np.random.default_rng(S).random((2, S, 8)).astype(np.float32) * 12
    np.testing.assert_array_equal(
        ssm._cumsum(_t(da)).numpy(), np.asarray(jnp.cumsum(da, axis=1)))
    np.testing.assert_array_equal(
        ssm._sum(_t(da)).numpy(),
        np.asarray(jnp.sum(jnp.asarray(da), axis=1, keepdims=True)))


def test_softplus_as_reference():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        np.random.default_rng(0).standard_normal(200)]
                       ).astype(np.float32)
    _close(ssm.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 16, 40])
def test_apply_full_as_reference(S):
    rcfg, rp, cfg, p = _layer(seed=S)
    x = _x(np.random.default_rng(S), 2, S, cfg.d_model)
    ry, rst = rssm.apply_full(rp, rcfg, jnp.asarray(x), jnp.float32)
    ty, tst = ssm.apply_full(p, cfg, _t(x), torch.float32)
    _close(ty, ry)
    _close(tst["conv"], rst["conv"])
    _close(tst["ssm"], rst["ssm"], _state_tol(p, cfg, x))


def _state_tol(p, cfg, x) -> float:
    """``_exp_tol`` of the layer's own ``dt`` on ``x``. The SSM state that
    ``apply_full`` hands to decode comes from ``_final_state``: exp of the
    difference of two float32 sums over the prompt, which keeps their
    rounding. The port sums in the reference's order, but its inputs to the
    sums come out of a matmul that rounds in another order, so the two
    states agree to a few ulps of those sums, not to ``RTOL``."""
    H = cfg.ssm_heads
    dt = np.logaddexp(x @ p.in_proj.numpy()[:, -H:] + p.dt_bias.numpy(), 0)
    return _exp_tol(dt, -np.exp(p.A_log.numpy()))


@pytest.mark.parametrize("S", [2, 40], ids=["S2_lt_K", "S40_3chunks"])
def test_prefill_then_decode_as_reference_and_float64(S):
    """A prefill of S tokens (40: three chunks of 16, 8 padded; 2: shorter
    than the conv's K-1 = 3), then 4 decode steps: y and both states
    against the reference's at every step, and the S + 4 outputs (to
    ``RTOL``) and the last states against the float64 loop over tokens."""
    rcfg, rp, cfg, p = _layer(seed=7)
    rng = np.random.default_rng(7)
    steps = 4
    x = _x(rng, 2, S + steps, cfg.d_model)
    ry, rst = rssm.apply_full(rp, rcfg, jnp.asarray(x[:, :S]), jnp.float32)
    ty, tst = ssm.apply_full(p, cfg, _t(x[:, :S]), torch.float32)
    ssm_tol = _state_tol(p, cfg, x[:, :S])
    _close(ty, ry)
    outs = [ty]
    for s in range(S, S + steps):
        ry, rst = rssm.apply_decode(rp, rcfg, jnp.asarray(x[:, s:s + 1]),
                                    rst, jnp.float32)
        ty, tst = ssm.apply_decode(p, cfg, _t(x[:, s:s + 1]), tst,
                                   torch.float32)
        _close(ty, ry)
        _close(tst["conv"], rst["conv"])
        _close(tst["ssm"], rst["ssm"], ssm_tol)
        outs.append(ty)
    y64, conv64, h64 = _layer64(p, cfg, x)
    _close(torch.cat(outs, 1), y64)
    _close(tst["conv"], conv64)
    _close(tst["ssm"], h64, ssm_tol)


def test_decode_does_not_write_its_inputs_and_reads_nothing_back():
    """``apply_decode`` returns new states (the model copies them into its
    cache) and dispatches no op that reads back to the host."""
    _, _, cfg, p = _layer(seed=2)
    rng = np.random.default_rng(2)
    _, st = ssm.apply_full(p, cfg, _t(_x(rng, 3, 5, cfg.d_model)),
                           torch.float32)
    before = {k: v.clone() for k, v in st.items()}

    class Ops(TorchDispatchMode):
        names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Ops() as rec:
        _, new = ssm.apply_decode(p, cfg, _t(_x(rng, 3, 1, cfg.d_model)), st,
                                  torch.float32)
    for k in st:
        assert torch.equal(st[k], before[k]), k
        assert not torch.equal(new[k], before[k]), k
    bad = {"nonzero", "unique", "_unique2", "masked_select",
           "_local_scalar_dense", "index", "nonzero_static"}
    assert not (rec.names & bad), rec.names & bad


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


def test_gated_norm_bf16_bit_equal_reference():
    """The norm after the gate in bfloat16, as the reference writes it
    (``ssm.py:161-164``): the float32 scaling rounded to bfloat16, then
    times ``norm_g`` in bfloat16. ``layers.rmsnorm_apply`` (times ``g`` in
    float32, rounded after) gives other bits on the same input."""
    rng = np.random.default_rng(0)
    y = jnp.asarray(_x(rng, 8, 4096) * 3, jnp.bfloat16)
    g = jnp.asarray(1 + 0.5 * _x(rng, 4096), jnp.bfloat16)
    yf = y.astype(jnp.float32)
    want = (yf * jax.lax.rsqrt(jnp.mean(yf * yf, -1, keepdims=True)
                               + 1e-5)).astype(jnp.bfloat16) * g
    ty = torch.from_numpy(np.asarray(y.astype(jnp.float32))).to(
        torch.bfloat16)
    tg = torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ssm._norm(ty, tg, 1e-5, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    norm = L.rmsnorm_init(4096, torch.bfloat16, device="cpu")
    with torch.no_grad():
        norm.g.copy_(tg)
    other = L.rmsnorm_apply(norm, ty, 1e-5, torch.bfloat16)
    assert not np.array_equal(other.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))


#: a bfloat16 layer against the reference's: the two packages' SiLU round
#: differently in bfloat16 (43 % of elements on the conv's output), so the
#: layer is held to 2^-5 of its largest |y|: about four bf16 roundings
#: (2^-9 each) that may differ in turn (the conv's SiLU, the gate, the
#: norm, the projection), with 4x to spare
BF16_RTOL = 2.0 ** -5


def test_apply_full_bf16_within_tolerance():
    rcfg, rp, cfg, p = _layer(seed=3)
    rbf = {k: v.astype(jnp.bfloat16) if k not in ("A_log", "D", "dt_bias")
           else v for k, v in rp.items()}
    pbf = ssm.init(None, cfg, torch.bfloat16, device="cpu")
    with torch.no_grad():
        for name, t in pbf.named_parameters():
            t.copy_(_t(np.asarray(rp[name], np.float32)))
    x = _x(np.random.default_rng(3), 2, 40, cfg.d_model)
    ry, _ = rssm.apply_full(rbf, rcfg, jnp.asarray(x, jnp.bfloat16),
                            jnp.bfloat16)
    ty, _ = ssm.apply_full(pbf, cfg, _t(x).to(torch.bfloat16),
                           torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    _close(ty.float(), np.asarray(ry.astype(jnp.float32)), BF16_RTOL)
