"""repro_torch's tensor-parallel prefill and decode over ``"model"``, one
rank per model shard, on the CPU under gloo.

One module-scoped spawn of four gloo ranks (``parallel.launch.spawn_ranks``;
the rank side is ``tests/torch_mesh_serve_cases.py``) runs every case at
(data, model) = (1, 2) on a subgroup of two ranks and at (2, 2) and (1, 4)
on the world group, while the parent runs each in the stacked form
(``launch.mesh.make_stacked_mesh``: every shard in one process) with one
intra-op thread, as the ranks have; the reference runs in two
subprocesses started first (``tests/torch_production_mesh_reference.py``:
``decode``, its prefill and decode chain on one device, and
``serve:2x2``, ``hlo_cost`` of its compiled prefill and decode steps on
a (2, 2) mesh of XLA host devices). Reduced configs of the six families
from the reference's initial parameters (JAX's draw at seed 0, carried
over as numpy arrays), prompts drawn by numpy from seed 0: 4 rows of 32
tokens (the vision stub's 8 patches or the audio stub's 8 frames a row
besides), a cache of 64 positions, then 4 greedy decode steps:

* (a) every rank's logits pieces, cache pieces and greedy tokens equal the
  stacked form's bit for bit, for the six families at (1, 2) (the
  KV-head rule), (2, 2) and (1, 4) (the query rows, the positions of the
  cache split), and an 8-head GQA config at (1, 4) (the GQA groups);
* (b) the stacked form against the one-device port
  (``transformer.forward_prefill``/``forward_decode``): the logits joined
  over the vocabulary shards and the caches joined to whole tensors
  within ``RTOL`` (the prefill's SSM state within ``SSM_STATE_RTOL``), the
  greedy tokens equal;
* (c) the stacked (2, 2) form against the reference's ``forward_prefill``
  and ``forward_decode`` + argmax: tokens equal, logits within ``RTOL``;
* (d) the meta count (``launch.dryrun.count_on_mesh`` on
  ``launch.mesh.make_meta_mesh``, each of the four ranks) at (2, 2): the
  ranks' FLOPs sum to the stacked form's ``FlopCounterMode`` count of the
  same step (a rank's share is the stacked shard's; model index 0 alone
  runs the vision projector), each rank's tally of bytes sent by dtype
  is what that rank sent in that step, and its cache bytes a device the
  reference's ``cache_spec_tree`` with its divisibility rule
  (``sanitize_spec``) for ``k``/``v``/``ek``/``ev``/``ssm``, the port's
  index set for ``conv``;
* (e) per-device dot FLOPs of the prefill and decode steps on (2, 2)
  against the reference's ``hlo_cost``, within ``HLO_RTOL``;
* the step makers on a mesh refuse nothing they should run and run no
  one-device step, and a planted fault (a decode whose row-parallel sums
  keep each shard's own partial) moves the logits past ``RTOL``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_mesh_serve_cases as cases
from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import transformer as rtfm
from repro.parallel.sharding import sanitize_spec
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import io_spec
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ShapeConfig
from repro_torch.parallel import launch
from test_torch_models import SSM_STATE_RTOL

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
TIMEOUT = 300           # the spawn's and the reference's timeout, seconds
_REFERENCE = (Path(__file__).resolve().parent
              / "torch_production_mesh_reference.py")
#: float32 values against the one-device port's and the reference's,
#: relative to the largest |value|: the stacked form computes the same
#: float32 sums split at other places (a row-parallel product's K range
#: in M partial sums added in rank order, the vocabulary's columns in M
#: products, the decode's softmax over M ranges of positions merged).
#: Each split moves a value by a few ulps (2^-24) of its largest terms,
#: and two layers chain a few dozen of them: below 1e-6 measured (logits
#: 4e-7 to 1.0e-6 of their largest against the one-device port), so the
#: packages' rule (``test_torch_models.RTOL``) holds with room; a cache
#: position misplaced or a partial dropped moves values by their own scale
RTOL = 1e-5
#: per-device dot FLOPs of the serving steps on (2, 2) against the
#: reference's ``hlo_cost``: dense, vlm and encdec are equal (vlm's mean
#: over the ranks: model index 0 alone runs the vision projector, where
#: XLA spreads it). The port may count at most this share more elsewhere,
#: measured: moe 1.0044 (prefill) and 1.0019 (decode), every model shard
#: routing the whole rows (not located further); ssm 1.0356 and 1.0290, hybrid 1.0157 and
#: 1.0142, Mamba2's ``B``/``C`` columns of ``in_proj`` and the conv whole
#: on every shard (the index set of the training layout), where the
#: reference splits the packed columns evenly
HLO_RTOL = {"prefill": {"moe": 0.006, "ssm": 0.04, "hybrid": 0.02},
            "decode": {"moe": 0.003, "ssm": 0.035, "hybrid": 0.02}}
#: the (2, 2) cells the meta count is held to: the prefill of every family
#: and the decode of all but encdec (the dry run's decode cache holds
#: ``seq_len // 4`` encoder frames, the runs here 8)
META_PREFILL = tuple(cases.FAMILIES)
META_DECODE = tuple(f for f in cases.FAMILIES if f != "encdec")


def _inits() -> dict:
    """The reference's initial parameters of each family as numpy trees,
    drawn with 64-bit types off, as the reference's subprocess draws
    them (``A_log``'s logarithm differs by an ulp under x64)."""
    with jax.enable_x64(False):
        return {fam: jax.tree.map(np.asarray, rtfm.init_params(
            rconfigs.reduce(rconfigs.get(arch)), jax.random.PRNGKey(0))[0])
            for fam, arch in cases.FAMILIES.items()}


def _one_device(family: str, params, batch: dict) -> dict:
    """``tfm.forward_prefill`` and ``TICKS`` greedy ``forward_decode``
    steps: logits, tokens and the caches, as numpy."""
    cfg = cases.cfg(family)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, cache = tfm.forward_prefill(cfg, params, b, cases.MAX_LEN)
    out = {"logits": [], "tokens": [],
           "cache_prefill": {k: v.numpy().copy() for k, v in cache.items()}}
    for i in range(cases.TICKS + 1):
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out["logits"].append(logits.numpy().copy())
        out["tokens"].append(tok.numpy().copy())
        if i < cases.TICKS:
            logits, cache = tfm.forward_decode(cfg, params, tok, cache)
    out["cache"] = {k: v.numpy().copy() for k, v in cache.items()}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_serve")
    inputs = {fam: cases.inputs(fam) for fam in list(cases.FAMILIES)
              + ["gqa"]}
    np.savez(root / "inputs.npz", **{f"{fam}/{k}": v for fam, b in
                                     inputs.items() for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    (root / "ref").mkdir()
    procs = {part: subprocess.Popen(
        [sys.executable, str(_REFERENCE), str(root / "ref"), part, "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for part in (f"decode:{root / 'inputs.npz'}", "serve:2x2")}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inits = _inits()
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch.spawn_ranks, cases.run_cases, WORLD,
                                backend="gloo", timeout=TIMEOUT,
                                args=({"init": inits, "inputs": inputs},))
            stacked = {}
            for name, (fam, d, m) in cases.case_names().items():
                mesh = tmesh.make_stacked_mesh(data=d, model=m, device="cpu")
                stacked[name] = cases.serve_run(
                    mesh, fam, cases.params_of(fam, inits), inputs[fam],
                    tally=False)
            one = {fam: _one_device(fam, cases.params_of(fam, inits),
                                    inputs[fam])
                   for fam in list(cases.FAMILIES) + ["gqa"]}
            ranks = ranks.result()
        done = {part: p.communicate(timeout=TIMEOUT)
                for part, p in procs.items()}
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    ref_meta = {}
    for part, (stdout, stderr) in done.items():
        assert procs[part].returncode == 0, (part, stderr[-4000:])
        ref_meta.update(json.loads(stdout.strip().splitlines()[-1]))
    return {"root": root, "inits": inits, "inputs": inputs, "ranks": ranks,
            "stacked": stacked, "one": one, "ref_meta": ref_meta,
            "ref": dict(np.load(root / "ref" / "ref_decode.npz"))}


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(-1)


def _same(a, b, what) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(what))


def _close(got, want, rtol=RTOL, what="") -> float:
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= rtol, (what, err)
    return err


def _plan(name: str):
    fam, _, m = cases.case_names()[name]
    return tp.make_plan(cases.cfg(fam), m)


def _whole_logits(name: str, per_shard: list) -> np.ndarray:
    """One step's logits joined: each data shard's vocabulary shards in
    model order, the data shards' rows after one another."""
    _, d, m = cases.case_names()[name]
    split = _plan(name).vocab
    rows = [np.concatenate(per_shard[q * m:(q + 1) * m], -1) if split
            else per_shard[q * m] for q in range(d)]
    return np.concatenate(rows, 0)


def _whole_cache(name: str, per_shard: list) -> dict:
    """The shards' caches joined to whole tensors
    (``tensor_parallel.cache_shapes``' layout): K/V on the heads (``"kv"``)
    or the positions, ``ssm`` on the heads, ``conv`` from each shard's
    ``x`` channels and one shard's ``B``/``C``; the data shards' rows
    after one another."""
    fam, d, m = cases.case_names()[name]
    cfg, plan = cases.cfg(fam), _plan(name)
    two_n = 2 * cfg.ssm_state
    out = {}
    for key in per_shard[0]:
        rows = []
        for q in range(d):
            sh = [per_shard[q * m + r][key] for r in range(m)]
            if key in ("k", "v", "ek", "ev"):
                t = np.concatenate(sh, 3 if plan.rule == "kv" else 2)
            elif key == "ssm" and plan.ssm:
                t = np.concatenate(sh, 2)
            elif key == "conv" and plan.ssm:
                t = np.concatenate([c[..., :-two_n] for c in sh]
                                   + [sh[0][..., -two_n:]], -1)
            else:
                t = sh[0]
                for r, x in enumerate(sh[1:], 1):
                    _same(x, t, (name, key, "model shard", r))
            rows.append(t)
        out[key] = np.concatenate(rows, 0 if key == "len" else 1)
    return out


# ---------------------------------------------------------------------------
# (a) the rank form against the stacked form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.case_names()))
def test_ranks_bit_equal_to_the_stacked_form(run, name):
    _, d, m = cases.case_names()[name]
    want = run["stacked"][name]
    for r in range(d * m):
        got = run["ranks"][r][name]
        for key in ("logits", "tokens"):
            assert len(got[key]) == cases.TICKS + 1
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                _same(g[0], w[r], (name, r, key, i))
        for key in ("cache_prefill", "cache"):
            assert list(got[key][0]) == list(want[key][r])
            for k, v in got[key][0].items():
                _same(v, want[key][r][k], (name, r, key, k))


def test_each_cache_layout_is_taken():
    """The KV-head rule splits the cache's heads, the others its
    positions; Mamba2's conv window holds the shard's channels and B/C."""
    seen = {}
    for name, (fam, d, m) in cases.case_names().items():
        ctx = tp.make_ctx(cases.cfg(fam), tmesh.make_stacked_mesh(
            data=d, model=m, device="cpu"), serve=True)
        seen[ctx.plan.rule] = name
        shapes = tp.cache_shapes(ctx, 2, cases.MAX_LEN, 8)
        cfg = cases.cfg(fam)
        if "k" in shapes:
            KV, hd = cfg.n_kv_heads, cfg.head_dim
            want = ((2, cases.MAX_LEN, KV // m, hd) if ctx.plan.rule == "kv"
                    else (2, cases.MAX_LEN // m, KV, hd))
            assert shapes["k"][0][1:] == want, name
        if "conv" in shapes:
            assert shapes["conv"][0][-1] == cfg.d_inner // m \
                + 2 * cfg.ssm_state
            assert shapes["ssm"][0][2] == cfg.ssm_heads // m
    assert set(seen) == {"kv", "g", "qc"}
    assert seen["g"] == "gqa_1x4"


# ---------------------------------------------------------------------------
# (b) the stacked form against the one-device port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.case_names()))
def test_stacked_form_matches_the_one_device_port(run, name):
    fam = cases.case_names()[name][0]
    st, one = run["stacked"][name], run["one"][fam]
    for i in range(cases.TICKS + 1):
        _close(_whole_logits(name, st["logits"][i]), one["logits"][i],
               what=(name, "logits", i))
        got = np.concatenate(st["tokens"][i][::cases.case_names()[name][2]])
        np.testing.assert_array_equal(got, one["tokens"][i])
    for key, rtol in (("cache_prefill", SSM_STATE_RTOL), ("cache", RTOL)):
        whole = _whole_cache(name, st[key])
        assert list(whole) == list(one[key]), (name, key)
        for k, want in one[key].items():
            assert whole[k].dtype == want.dtype, (name, k)
            if k == "len":
                np.testing.assert_array_equal(whole[k], want)
            else:
                _close(whole[k], want, rtol if k == "ssm" else RTOL,
                       (name, key, k))


def test_planted_fault_moves_the_logits(run, monkeypatch):
    """A decode whose row-parallel sums keep each shard's own partial
    (the fault ``chip_smoke.py`` plants) moves the logits past ``RTOL``
    from the one-device port's."""
    monkeypatch.setattr(tp, "_row_sum", lambda ctx, xs: list(xs))
    name = "dense_1x2"
    got = cases.serve_run(tmesh.make_stacked_mesh(data=1, model=2,
                                                  device="cpu"), "dense",
                          cases.params_of("dense", run["inits"]),
                          run["inputs"]["dense"], tally=False)
    with pytest.raises(AssertionError):
        _close(_whole_logits(name, got["logits"][1]),
               run["one"]["dense"]["logits"][1])


# ---------------------------------------------------------------------------
# (c) the slice against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_stacked_form_matches_the_reference(run, family):
    name = f"{family}_2x2"
    st, ref = run["stacked"][name], run["ref"]
    for i in range(cases.TICKS + 1):
        _close(_whole_logits(name, st["logits"][i]),
               ref[f"logits_{family}/{i}"], what=(name, i))
        got = np.concatenate(st["tokens"][i][::2])[:, 0]
        np.testing.assert_array_equal(got, ref[f"tokens_{family}/{i}"])
    whole = _whole_cache(name, st["cache"])
    for k, v in whole.items():
        want = ref[f"cache_{family}/{k}"]
        if k == "len":
            np.testing.assert_array_equal(v, want)
        else:
            _close(v, want, what=(name, k))


# ---------------------------------------------------------------------------
# (d) the meta count at (2, 2)
# ---------------------------------------------------------------------------


def _shape(family: str, kind: str) -> ShapeConfig:
    """The dry run's shape of this file's runs: the prompt's positions
    (the vision stub's patches with its tokens), or the cache's."""
    cfg = cases.cfg(family)
    S = cases.SEQ + (cases.STUB if cfg.frontend == "vision_stub" else 0)
    return ShapeConfig("x", S if kind == "prefill" else cases.MAX_LEN,
                       cases.BATCH, kind)


def _stacked_flops(family: str, kind: str, inits, inputs) -> int:
    """``FlopCounterMode``'s FLOPs of the stacked (2, 2) form's prefill, or
    of its first decode step (the step of ``launch.steps``), every shard's,
    counted on a run of its own."""
    cfg = cases.cfg(family)
    mesh = tmesh.make_stacked_mesh(data=2, model=2, device="cpu")
    pre = steps.make_prefill_step(cfg, cases.MAX_LEN, mesh)
    ctx = pre.ctx
    pieces = tp.serve_pieces(ctx.layout, cases.params_of(family, inits),
                             ctx.ranks)
    rows = cases.BATCH // 2
    batches = [{k: torch.from_numpy(v[q * rows:(q + 1) * rows])
                for k, v in inputs.items()}
               for q in (mesh.dp_index(s) for s in mesh.local)]
    with FlopCounterMode(display=False) as fc:
        logits, caches = pre(pieces, batches)
    if kind == "decode":
        dec = steps.make_decode_step(cfg, mesh)
        toks = tp.next_tokens(ctx, logits)
        with FlopCounterMode(display=False) as fc:
            dec(pieces, toks, caches)
    return fc.get_total_flops()


def _reference_cache_bytes(family: str, shape: ShapeConfig) -> dict:
    """Per-device bytes of each cache leaf on (data 2, model 2) by the
    reference's ``cache_spec_tree`` and its divisibility rule."""
    rcfg = rconfigs.reduce(rconfigs.get(cases.FAMILIES[family]))
    tree = jax.eval_shape(lambda: rtfm.init_cache(
        rcfg, shape.global_batch, shape.seq_len,
        enc_len=io_spec.frontend_lens(cases.cfg(family), shape.seq_len)[0]
        if rcfg.family == "encdec" else 0))
    specs = rsteps.cache_spec_tree(rcfg, tree)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 2)))
    out = {}
    for k, leaf in tree.items():
        spec = sanitize_spec(specs[k], leaf.shape, mesh)
        n = leaf.dtype.itemsize
        for dim, e in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            names = () if e is None else (e if isinstance(e, tuple)
                                          else (e,))
            n *= dim // (2 ** len(names))
        out[k] = n
    return out


@pytest.mark.parametrize("kind,family",
                         [("prefill", f) for f in META_PREFILL]
                         + [("decode", f) for f in META_DECODE])
def test_meta_count_equals_the_ranks_and_the_stacked_form(run, kind,
                                                          family):
    shape = _shape(family, kind)
    each = [dryrun.count_on_mesh(cases.cfg(family), shape,
                                 tmesh.make_meta_mesh(data=2, model=2,
                                                      index=r))[0]
            for r in range(WORLD)]
    assert sum(f["cost"]["flops"] for f in each) == _stacked_flops(
        family, kind, run["inits"], run["inputs"][family])
    # the bytes each rank handed to the collectives in that step
    step = 0 if kind == "prefill" else 1
    for r, fields in enumerate(each):
        got = run["ranks"][r][f"{family}_2x2"]["wire"]
        assert got[step] == fields["collective_bytes_by_dtype"], (r, got)
        if kind == "decode":
            assert all(w == got[1] for w in got[1:])
        assert fields["collective_bytes"] == sum(
            fields["collective_bytes_by_dtype"].values()) > 0
    fields = each[0]
    mesh = tmesh.make_meta_mesh(data=2, model=2)
    # the cache a device holds
    ctx = tp.make_ctx(cases.cfg(family), mesh, serve=True)
    enc = 8 if family == "encdec" else 0
    mine = tp.cache_shapes(ctx, 2, cases.MAX_LEN if kind == "decode"
                           else shape.seq_len, enc)
    nbytes = {k: int(np.prod(s)) * torch.empty((), dtype=t).element_size()
              for k, (s, t) in mine.items()}
    assert fields["cache_bytes_per_device"] == sum(nbytes.values())
    if kind == "decode":
        ref = _reference_cache_bytes(family, shape)
        for k in ("k", "v", "ek", "ev", "ssm"):
            if k in ref:
                assert nbytes[k] == ref[k], (k, nbytes[k], ref[k])
        if "conv" in mine:
            cfg = cases.cfg(family)
            assert nbytes["conv"] == cfg.n_layers * 2 * (cfg.ssm_conv - 1) \
                * (cfg.d_inner // 2 + 2 * cfg.ssm_state) * 4
    pieces = tp.serve_pieces(ctx.layout, tfm.Transformer(
        cases.cfg(family), dtype=cases.cfg(family).dtype, device="meta"),
        ctx.ranks)
    assert fields["param_bytes_per_device"] == dryrun._tree_bytes(pieces)


def test_cache_bytes_of_the_production_decode_cell():
    """qwen2-0.5b x decode_32k on 16 x 16 holds 201,326,592 B of K/V a
    device, the whole 51,539,607,552 B over 256, as the reference's
    ``cache_spec_tree`` puts it (the head dim over the model axis); counted
    from the layout, no trace."""
    ctx = tp.make_ctx(configs.get("qwen2-0.5b"),
                      tmesh.make_production_mesh(), serve=True)
    shapes = tp.cache_shapes(ctx, 128 // 16, 32_768)
    kv = sum(int(np.prod(shapes[k][0])) * 2 for k in ("k", "v"))
    assert kv == 201_326_592 == 2 * 24 * 128 * 32_768 * 2 * 64 * 2 // 256


# ---------------------------------------------------------------------------
# (e) dot FLOPs against the reference's hlo_cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_dot_flops_match_reference_hlo(run, family, kind):
    cfg = cases.cfg(family)
    if cfg.family == "hybrid":
        # hlo_cost counts the lax.cond's shared block at every layer
        cfg = dataclasses.replace(cfg, attn_every=1)
    S = 32 if kind == "prefill" else cases.MAX_LEN
    ours = sum(dryrun.count_on_mesh(
        cfg, ShapeConfig("x", S, cases.BATCH, kind),
        tmesh.make_meta_mesh(data=2, model=2, index=r))[0]["cost"]["flops"]
        for r in range(WORLD)) / WORLD
    ref = run["ref_meta"][f"hlo_{family}_{kind}_2x2"]
    rtol = HLO_RTOL[kind].get(family, 0.0)
    if rtol == 0.0:
        assert ours == ref, ours / ref
    else:
        assert ref <= ours <= ref * (1 + rtol), ours / ref


# ---------------------------------------------------------------------------
# the step makers
# ---------------------------------------------------------------------------


def test_steps_on_a_mesh_run_the_tensor_parallel_forward():
    """On a mesh of shards the step makers give the tensor-parallel steps
    (``ctx``), on the one-device mesh the one-device steps; a cache whose
    positions M does not divide raises."""
    cfg = cases.cfg("dense")
    one = tmesh.make_debug_mesh(device="cpu")
    for make in (lambda m: steps.make_prefill_step(cfg, 64, m),
                 lambda m: steps.make_decode_step(cfg, m)):
        assert getattr(make(one), "ctx", None) is None
        assert getattr(make(None), "ctx", None) is None
        stacked = make(tmesh.make_stacked_mesh(data=1, model=4,
                                               device="cpu"))
        assert stacked.ctx.serve and stacked.ctx.plan.rule == "qc"
    ctx = tp.make_ctx(cfg, tmesh.make_stacked_mesh(data=1, model=4,
                                                   device="cpu"), serve=True)
    with pytest.raises(ValueError, match="equal range"):
        tp.cache_shapes(ctx, 2, 62)


def test_padded_vocabulary_on_the_model_shards():
    """A vocabulary the padding rounds up (500 of 512 columns, split over
    two model shards): the stacked form's real columns within ``RTOL`` of
    the one-device port's, its padded columns at -1e30 as the one
    device's, the greedy tokens equal and never a padded column, and
    ``make_decode_step`` on the mesh the decode and the argmax across
    the shards."""
    cfg = dataclasses.replace(cases.cfg("dense"), vocab=500)
    params = tfm.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(cases.inputs("dense")["tokens"]
                                        % cfg.vocab)}
    want, cache = tfm.forward_prefill(cfg, params, batch, cases.MAX_LEN)
    mesh = tmesh.make_stacked_mesh(data=1, model=2, device="cpu")
    pre = steps.make_prefill_step(cfg, cases.MAX_LEN, mesh)
    dec = steps.make_decode_step(cfg, mesh)
    pieces = tp.serve_pieces(pre.ctx.layout, params, pre.ctx.ranks)
    logits, caches = pre(pieces, [batch] * 2)
    tok = tp.next_tokens(pre.ctx, logits)
    for _ in range(cases.TICKS):
        got = torch.cat(logits, -1)
        _close(got[..., :cfg.vocab].numpy(), want[..., :cfg.vocab].numpy())
        assert torch.equal(got[..., cfg.vocab:], want[..., cfg.vocab:])
        one = torch.argmax(want[:, -1], -1).to(torch.int32)[:, None]
        assert torch.equal(tok[0], one) and torch.equal(tok[1], one)
        assert int(one.max()) < cfg.vocab
        stepped, _ = dec(pieces, tok, [{k: v.clone() for k, v in c.items()}
                                       for c in caches])
        want, cache = tfm.forward_decode(cfg, params, one, cache)
        logits, caches = tp.forward_decode(pre.ctx, pieces, tok, caches)
        tok = tp.next_tokens(pre.ctx, logits)
        assert all(torch.equal(a, b) for a, b in zip(stepped, tok))
