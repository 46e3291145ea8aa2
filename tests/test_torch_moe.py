"""repro_torch's MoE layer against the reference's, on the CPU.

* ``padded_experts`` and the capacity rule, equal to the reference's;
* ``init``'s leaf shapes against the reference's ``moe.init`` (reduced
  qwen2-moe-a2.7b and dbrx-132b, and the published widths on the meta
  device);
* ``apply`` on the reference's parameters at S = 1 (a decode step), at
  S = 11 with the published capacity factor (assignments dropped; the
  test asserts that some were), and at ``capacity_factor = E/k`` (cap
  >= S, nothing dropped): y within ``RTOL`` relative to its largest
  magnitude, the expert ids and the kept set of (row, token, expert)
  equal exactly, ``moe_lb`` and ``moe_z`` within ``RTOL``;
* two calls give the same bits (the combine has one order), the layer
  dispatches no op that reads back to the host, and the router stays
  float32 after ``cast_params`` and after the one-copy init;
* the two helpers phase 15 of ``chip_smoke.py`` checks decode against
  prefill with: ``pinned`` (a one-token routing sent to given experts)
  and ``route_tap`` (which fails unless the model routed through
  ``moe.route`` once a layer).

The reference's kept set is its rule applied to its own top-k ids: per
batch row, each expert keeps its first ``cap`` assignments in assignment
order (the stable argsort of ``moe.py:95``).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

RTOL = 1e-5
ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
#: (label, S, capacity factor: None keeps the config's)
CASES = (("decode_S1", 1, None), ("drops_S11", 11, None),
         ("no_drop_cf_E_over_k", 11, "E/k"))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, err


def _layer(arch, seed=0, cf=None):
    """The reference's MoE layer and the port's holding its tensors."""
    rcfg = rconfigs.reduce(rconfigs.get(arch))
    cfg = configs.reduce(configs.get(arch))
    if cf == "E/k":
        rcfg = dataclasses.replace(
            rcfg, capacity_factor=rcfg.n_experts / rcfg.top_k)
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    rp, _ = rmoe.init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    p = moe.init(None, cfg, torch.float32, device="cpu")
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(np.array(rp["router"])))
        for name in ("wi", "wg", "wo"):
            getattr(p.experts, name).copy_(
                torch.from_numpy(np.array(rp[name])))
            if p.shared is not None:
                getattr(p.shared, name).copy_(
                    torch.from_numpy(np.array(rp["shared"][name]["w"])))
    return rcfg, rp, cfg, p


def _ref_kept(rp, rcfg, x):
    """The reference's top-k ids and its kept set of (row, token, expert):
    its router (``moe.py:77-79``), then its capacity rule by hand."""
    logits = (jnp.asarray(x).astype(jnp.float32) @ rp["router"]).astype(
        jnp.float32)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), rcfg.top_k)
    ids = np.asarray(ids)
    B, S, k = ids.shape
    cap = int(np.ceil(S * k / rcfg.n_experts * rcfg.capacity_factor))
    kept = set()
    for b in range(B):
        seen = np.zeros(rcfg.n_experts, np.int64)
        for a in range(S * k):
            e = int(ids[b, a // k, a % k])
            if seen[e] < cap:
                kept.add((b, a // k, e))
            seen[e] += 1
    return ids, kept, B * S * k - len(kept)


def _port_kept(r: moe.Routing, k: int):
    ids = r.experts.numpy()
    keep = r.keep.numpy()
    B, A = keep.shape
    return {(b, a // k, int(ids[b, a // k, a % k]))
            for b in range(B) for a in range(A) if keep[b, a]}


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("E", [1, 8, 15, 16, 17, 60, 64])
def test_padded_experts_equal(E):
    assert moe.padded_experts(E) == rmoe.padded_experts(E)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equal_reference_rule(arch):
    for cfg in (configs.get(arch), configs.reduce(configs.get(arch))):
        for S in range(1, 40):
            assert moe.capacity(cfg, S) == int(np.ceil(
                S * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    # at qwen2-moe's published sizes one slot an expert up to S = 12
    if arch == "qwen2-moe-a2.7b":
        cfg = configs.get(arch)
        assert [moe.capacity(cfg, S) for S in range(1, 14)] == [1] * 12 + [2]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_leaf_shapes_equal(arch):
    rcfg = rconfigs.reduce(rconfigs.get(arch))
    cfg = configs.reduce(configs.get(arch))
    rp, _ = rmoe.init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = moe.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                 device="cpu")
    assert tuple(p.router.shape) == rp["router"].shape
    for name in ("wi", "wg", "wo"):
        assert tuple(getattr(p.experts, name).shape) == rp[name].shape
        if cfg.n_shared_experts:
            assert tuple(getattr(p.shared, name).shape) == \
                rp["shared"][name]["w"].shape
    assert (p.shared is None) == ("shared" not in rp)
    # drawn within the reference's bounds, not left empty
    d, ff = cfg.d_model, cfg.d_ff
    assert float(p.router.abs().max()) <= 1 / np.sqrt(d)
    assert float(p.experts.wo.abs().max()) <= 1 / np.sqrt(ff)
    assert float(p.experts.wi.abs().max()) > 0.5 / np.sqrt(d)


@pytest.mark.parametrize("arch", ARCHS)
def test_published_widths_on_meta(arch):
    cfg = configs.get(arch)
    p = moe.init(None, cfg, torch.bfloat16, device="meta")
    Ep = moe.padded_experts(cfg.n_experts)
    assert tuple(p.experts.wi.shape) == (Ep, cfg.d_model, cfg.d_ff)
    assert tuple(p.experts.wo.shape) == (Ep, cfg.d_ff, cfg.d_model)
    assert tuple(p.router.shape) == (cfg.d_model, cfg.n_experts)
    assert p.router.dtype == torch.float32
    assert p.experts.wi.dtype == torch.bfloat16
    n_sh = cfg.n_shared_experts
    assert (p.shared is None) == (n_sh == 0)
    if n_sh:
        assert tuple(p.shared.wg.shape) == (n_sh, cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_equal_reference(arch, case):
    _, S, cf = case
    rcfg, rp, cfg, p = _layer(arch, cf=cf)
    B = 3
    # the drop case takes the first seed whose batch drops
    for seed in range(20):
        x = _x(cfg, B, S, seed)
        ids, kept, dropped = _ref_kept(rp, rcfg, x)
        if case[0] != "drops_S11" or dropped:
            break
    ry, raux = rmoe.apply(rp, rcfg, jnp.asarray(x), jnp.float32)
    y, aux = moe.apply(p, cfg, torch.from_numpy(x), torch.float32)
    r = moe.route(p, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(r.experts.numpy(), ids)
    assert _port_kept(r, cfg.top_k) == kept
    assert int((~r.keep).sum()) == dropped
    if case[0] == "drops_S11":
        assert dropped > 0
    else:
        assert dropped == 0
    _close(y, ry)
    for key in ("moe_lb", "moe_z"):
        _close(aux[key], raux[key])
    # the reference's capacity
    assert r.cap == int(np.ceil(S * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_same_bits_twice_and_aux_off(arch):
    _, _, cfg, p = _layer(arch, seed=2)
    x = torch.from_numpy(_x(cfg, 2, 11, 5))
    y1, a1 = moe.apply(p, cfg, x, torch.float32)
    y2, a2 = moe.apply(p, cfg, x, torch.float32)
    y3, a3 = moe.apply(p, cfg, x, torch.float32, aux=False)
    assert torch.equal(y1, y2) and torch.equal(y1, y3)
    assert a3 == {}
    for key in a1:
        assert torch.equal(a1[key], a2[key])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S", [1, 11])
def test_apply_reads_nothing_back_to_the_host(S):
    """No op whose result the host must read: ``nonzero``, ``unique``,
    ``bincount``, boolean-mask indexing (``masked_select``, ``index``
    with a mask), ``.item()`` (``_local_scalar_dense``)."""
    _, _, cfg, p = _layer("qwen2-moe-a2.7b", seed=3)
    x = torch.from_numpy(_x(cfg, 2, S, 6))
    with _Ops() as rec:
        moe.apply(p, cfg, x, torch.float32)
    bad = {"nonzero", "unique", "_unique", "_unique2", "unique_consecutive",
           "unique_dim", "bincount", "masked_select", "_local_scalar_dense",
           "index", "nonzero_static"}
    assert not (rec.names & bad), rec.names & bad


@pytest.mark.parametrize("arch", ARCHS)
def test_router_stays_float32(arch):
    cfg = dataclasses.replace(configs.reduce(configs.get(arch)),
                              dtype="bfloat16")
    p32 = tfm.init_params(cfg, 1, device="cpu")
    cast = tfm.cast_params(p32, cfg.dtype)
    once = tfm.init_params(cfg, 1, device="cpu", dtype=cfg.dtype)
    for params in (cast, once):
        for b in params.blocks:
            assert b.moe.router.dtype == torch.float32
            assert b.moe.experts.wi.dtype == torch.bfloat16
        assert params.dtype == torch.bfloat16
    for a, b in zip(cast.blocks, p32.blocks):
        assert torch.equal(a.moe.router, b.moe.router)


def test_bf16_layer_runs_and_is_finite():
    cfg = dataclasses.replace(configs.reduce(configs.get("qwen2-moe-a2.7b")),
                              dtype="bfloat16")
    params = tfm.init_params(cfg, 4, device="cpu", dtype=cfg.dtype)
    x = torch.from_numpy(_x(cfg, 2, 5, 7)).to(torch.bfloat16)
    y, aux = moe.apply(params.blocks[0].moe, cfg, x, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert torch.isfinite(y).all()
    assert aux["moe_lb"].dtype == torch.float32


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, loaded as a module (it
    imports nothing of JAX and needs no card to import)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_pinned_routing(arch):
    """Pinned to the experts the router chose, a one-token routing is the
    same bits; pinned to others, the layer's y is their gated SwiGLU sum
    (gates the router's probabilities there, renormalised) plus the
    shared experts, against float64."""
    cs = _chip_smoke()
    _, _, cfg, p = _layer(arch, seed=1)
    k = cfg.top_k
    x = torch.from_numpy(_x(cfg, 3, 1, 8))
    r = moe.route(p, cfg, x)
    same = cs.pinned(r, r.experts)
    for field in ("gates", "experts", "keep", "slot"):
        assert torch.equal(getattr(same, field), getattr(r, field)), field
    other = torch.topk(r.probs, k + 1, dim=-1).indices[..., 1:]
    with cs.route_tap(moe, lambda _, r_: cs.pinned(r_, other), 1):
        y, _ = moe.apply(p, cfg, x, torch.float32, aux=False)

    def swiglu(wi, wg, wo, v):
        return (torch.nn.functional.silu(v @ wg.double())
                * (v @ wi.double())) @ wo.double()

    x64 = x.double()
    want = torch.zeros_like(x64)
    g = torch.gather(r.probs.double(), -1, other)
    g = g / g.sum(-1, keepdim=True)
    ex = p.experts
    for b in range(x.shape[0]):
        for j in range(k):
            e = int(other[b, 0, j])
            want[b, 0] += g[b, 0, j] * swiglu(ex.wi[e], ex.wg[e], ex.wo[e],
                                              x64[b, 0])
    if p.shared is not None:
        for i in range(p.shared.wi.shape[0]):
            want += swiglu(p.shared.wi[i], p.shared.wg[i], p.shared.wo[i],
                           x64)
    _close(y, want.numpy())
    with pytest.raises(RuntimeError, match="one token"):
        cs.pinned(moe.route(p, cfg, torch.from_numpy(_x(cfg, 1, 2, 9))),
                  other[:1])


def test_route_tap_fails_unless_every_layer_routes_through_it():
    cs = _chip_smoke()
    cfg = configs.reduce(configs.get("qwen2-moe-a2.7b"))
    params = tfm.init_params(cfg, 0, device="cpu")
    route = moe.route
    batch = {"tokens": torch.ones((1, 3), dtype=torch.int32)}
    seen = []

    def each(x, r):
        seen.append(x.shape[1])
        return r

    with cs.route_tap(moe, each, cfg.n_layers):
        tfm.forward_prefill(cfg, params, batch, 8)
    assert seen == [3] * cfg.n_layers and moe.route is route
    with cs.route_tap(moe, each, cfg.n_layers, exact=False):
        tfm.forward_prefill(cfg, params, batch, 8)
        tfm.forward_prefill(cfg, params, batch, 8)
    for want, exact in ((cfg.n_layers + 1, True), (cfg.n_layers * 3, False)):
        with pytest.raises(RuntimeError, match="moe.route"):
            with cs.route_tap(moe, each, want, exact=exact):
                tfm.forward_prefill(cfg, params, batch, 8)
        assert moe.route is route
