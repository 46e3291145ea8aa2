"""repro_torch's training forward against the reference's, on the CPU.

* ``forward_train``'s loss and every leaf of its gradient
  (``jax.value_and_grad`` against autograd) for the six families:
  reduced qwen2-0.5b (dense: tied head, QKV bias), qwen2-moe-a2.7b
  (shared experts, the aux terms), llava-next-mistral-7b (patches
  through the projector), mamba2-1.3b, zamba2-2.7b (the shared block
  after every 2nd layer) and seamless-m4t-large-v2 (frames through the
  encoder, cross-attention);
* a sequence that is no multiple of the CE chunk (600 = 512 + 88, the
  padding of the last chunk) and a padded vocab (500 -> 512, its columns
  at -1e30); ``chunked_ce_loss`` on its own with small chunks;
* the training cast rule in bfloat16: ``_cast_block`` of a moe block and
  of a Mamba2 block bit-equal to the reference's ``_cast_block`` (the
  router and ``A_log``, ``D``, ``dt_bias`` rounded too); the bf16 loss of
  the trainer's compute parameters against the reference's;
* the parameter layout: ``reference_leaves`` in the reference's leaf
  order and ``to_reference_params`` the inverse of
  ``load_reference_params`` for all ten configs.

The reference's parameters are carried across
(``load_reference_params``) and its gradients compared through
``to_reference_params``. The reduced configs compute in float32: the
loss within ``LOSS_RTOL``, each gradient leaf within ``GRAD_RTOL`` of
its largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import transformer as tfm

#: the float32 loss: the two packages' sums run in other orders
LOSS_RTOL = 1e-6
#: a float32 gradient leaf, relative to its largest |value|: the backward
#: sums over tokens, heads and layers in other orders (5.3e-6 at most,
#: measured, on mamba2's SSD)
GRAD_RTOL = 3e-5
#: the bf16 loss of the same master: both packages round every product and
#: activation to bf16 (2^-9 relative each), in another order of sums
BF16_LOSS_RTOL = 2.0 ** -8
FAMILIES = ("qwen2-0.5b", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
            "mamba2-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2")


def _cfgs(arch, **kw):
    cfg = dataclasses.replace(configs.reduce(configs.get(arch)), **kw)
    rcfg = dataclasses.replace(rconfigs.reduce(rconfigs.get(arch)), **kw)
    return cfg, rcfg


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        b["patches"] = rng.standard_normal((B, 6, 1024)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        b["frames"] = rng.standard_normal((B, 10, 1024)).astype(np.float32)
    return b


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_params(rcfg, seed=1):
    return jax.tree.map(np.asarray, rtfm.init_params(
        rcfg, jax.random.PRNGKey(seed))[0])


def _check(arch, B=2, S=24, **kw):
    cfg, rcfg = _cfgs(arch, **kw)
    rp = _ref_params(rcfg)
    b = _batch(cfg, B, S)
    rl, rg = jax.value_and_grad(
        lambda p: rtfm.forward_train(rcfg, p, b))(rp)
    master = tfm.load_reference_params(cfg, rp, device="cpu")
    master.requires_grad_(True)
    loss, grads = steps.value_and_grad(
        cfg, master, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(loss.item(), float(rl), rtol=LOSS_RTOL)
    g = tfm.Transformer(cfg, device="cpu")
    with torch.no_grad():
        for d, t in zip(g.parameters(), grads):
            d.copy_(t)
    got, want = _leaves(tfm.to_reference_params(g)), _leaves(rg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= GRAD_RTOL, (k, err)
    return float(rl)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_loss_and_every_gradient(arch):
    loss = _check(arch)
    assert 5.0 < loss < 8.0          # about ln(512) at init


def test_sequence_past_one_ce_chunk_and_padded_vocab():
    """S = 600: two CE chunks of 512, the second padded by 424; vocab
    500 in a 512-row table, the padded columns masked."""
    _check("qwen2-0.5b", B=1, S=600, vocab=500)


def test_chunked_ce_loss_small_chunks():
    cfg, rcfg = _cfgs("qwen2-0.5b", vocab=500)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, 16)).astype(np.float32)
    w = rng.standard_normal((16, 512)).astype(np.float32)
    lab = rng.integers(0, 500, (2, 21)).astype(np.int32)
    mask = (rng.random((2, 21)) > 0.3).astype(np.float32)
    for chunk in (4, 8, 21, 64):
        wt, wc = rtfm.chunked_ce_loss(rcfg, jnp.asarray(w), jnp.asarray(x),
                                      jnp.asarray(lab), jnp.asarray(mask),
                                      chunk=chunk)
        gt, gc = tfm.chunked_ce_loss(cfg, torch.from_numpy(w),
                                     torch.from_numpy(x),
                                     torch.from_numpy(lab),
                                     torch.from_numpy(mask), chunk=chunk)
        np.testing.assert_allclose(gt.item(), float(wt), rtol=LOSS_RTOL)
        assert gc.item() == float(wc)


@pytest.mark.parametrize("arch,leaf", [("qwen2-moe-a2.7b", "moe"),
                                       ("mamba2-1.3b", "ssm")])
def test_training_cast_rule_bit_equal(arch, leaf):
    """``_cast_block`` of layer 1 in bf16: every floating leaf rounded, the
    float32 router and Mamba2's ``A_log``/``D``/``dt_bias`` too, equal to
    the reference's ``_cast_block`` bit for bit."""
    cfg, rcfg = _cfgs(arch, dtype="bfloat16")
    rp = _ref_params(rcfg)
    layer = jax.tree.map(lambda a: a[1], rp["blocks"])
    want = _leaves(rtfm._cast_block(layer, jnp.bfloat16))
    p = tfm.load_reference_params(cfg, rp, device="cpu")
    view = tfm._cast_block(p.blocks[1], torch.bfloat16)
    sub = getattr(view, leaf)
    named = dict(p.blocks[1].named_parameters())
    assert any(t.dtype == torch.float32 for n, t in named.items()
               if n.startswith(leaf + "."))
    seen = 0
    for name in named:
        obj = view
        for part in name.split("."):
            obj = getattr(obj, part)
        key = "/".join(tfm._ref_path("blocks.0." + name)[1:])
        assert obj.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            obj.to(torch.float32).numpy(),
            np.asarray(want[key].astype(jnp.float32)), name)
        seen += 1
    assert seen == len(want)
    assert sub is not None


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_bf16_loss_against_the_reference(arch):
    """The trainer's loss in bfloat16 (non-block leaves cast once, blocks
    per layer) against the reference's on the same float32 master."""
    cfg, rcfg = _cfgs(arch, dtype="bfloat16")
    rp = _ref_params(rcfg)
    b = _batch(cfg, 2, 24)
    cast = {k: (v if k in ("blocks", "enc_blocks") else jax.tree.map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), v))
        for k, v in rp.items()}
    want = float(rtfm.forward_train(rcfg, cast, b))
    master = tfm.load_reference_params(cfg, rp, device="cpu")
    got = steps.loss_fn(cfg, master,
                        {k: torch.from_numpy(v) for k, v in b.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_reference_layout_round_trip(arch):
    cfg, rcfg = _cfgs(arch)
    rp = _ref_params(rcfg, seed=2)
    p = tfm.load_reference_params(cfg, rp, device="cpu")
    want = _leaves(rp)
    assert ["/".join(path) for path, _ in tfm.reference_leaves(p)] == \
        list(want)
    got = _leaves(tfm.to_reference_params(p))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w.astype(np.float32), k)
    groups = tfm.reference_groups(p)
    assert sorted(i for g in groups for i in g) == list(
        range(len(list(p.parameters()))))
