"""repro_torch codecs and delta encoding against the reference, on the CPU.

The port's host encoders must produce the reference's words byte for
byte over every codec × D, the codec edge cases included (ties-to-even,
halfway boundaries, subnormals, inf/NaN, D at both ends), and its torch
Fig. 3b decode must equal ``repro.core.codecs.unpack_words_np``.
"""
import numpy as np
import pytest
import torch

from repro.core import codecs as rcd
from repro.core import delta as rde
from repro_torch.core import codecs as tcd
from repro_torch.core import delta as tde

F32 = np.float32

CASES = ([("fp16", D) for D in (1, 4, 8, 12, 15)]
         + [("bf16", D) for D in (1, 8, 15)]
         + [("e8m", D) for D in (1, 4, 8, 12, 15, 18, 22)]
         + [("fixed12", D) for D in (4, 15)]
         + [("fixed16", D) for D in (10, 24)]
         + [("fixed8", D) for D in (1, 15)])


def _edge_values(D: int) -> np.ndarray:
    """The special and boundary values of tests/test_codec_edges.py."""
    ties = [0x3F800000 | (k << (D + 1)) | (1 << D) for k in range(4)]
    above = [0x3F800000 | (1 << D) | 1]
    below = [0x3F800000 | ((1 << D) - 1)]
    bits = np.array(ties + above + below + [0xFFFFFFFF, 0x7FFFFFFF,
                                           0x7F800001, 0xFF800000],
                    np.uint32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4028235e38,
                        -3.4028235e38, 1e-40, -1e-40, 2.0 ** -149, 65504.0,
                        65520.0, 2.0 ** -24, 6e-8], F32)
    return np.concatenate([bits.view(F32), special])


def _values(D: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rand = (rng.standard_normal(512) * np.exp(rng.uniform(-20, 20, 512)))
    return np.concatenate([_edge_values(D), rand.astype(F32),
                           rng.uniform(-100, 100, 256).astype(F32)])


def _stream(D: int, seed: int, n: int):
    """A random (values, deltas, flags) word stream: flag-1 deltas fit D
    bits, flag-0 (dummy) deltas use the 31-bit field."""
    rng = np.random.default_rng(seed)
    vals = _values(D, seed)[:n]
    flags = (rng.random(len(vals)) < 0.8).astype(np.uint8)
    deltas = np.where(flags == 1, rng.integers(0, 1 << D, len(vals)),
                      rng.integers(0, 1 << 31, len(vals)))
    return vals, deltas, flags


@pytest.mark.parametrize("name,D", CASES)
def test_pack_words_byte_equal(name, D):
    vals, deltas, flags = _stream(D, seed=D, n=10_000)
    with np.errstate(invalid="ignore"):     # fixed<F> casts of NaN/inf
        want = rcd.pack_words_np(vals, deltas, flags, rcd.make_codec(name), D)
        got = tcd.pack_words_np(vals, deltas, flags, tcd.make_codec(name), D)
        q_ref = rcd.quantize_np(vals, rcd.make_codec(name), D)
        q = tcd.quantize_np(vals, tcd.make_codec(name), D)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(q.view(np.uint32), q_ref.view(np.uint32))


@pytest.mark.parametrize("name,D", CASES)
def test_torch_decode_equals_unpack_words_np(name, D):
    vals, deltas, flags = _stream(D, seed=100 + D, n=10_000)
    with np.errstate(invalid="ignore"):     # fixed<F> casts of NaN/inf
        words = rcd.pack_words_np(vals, deltas, flags, rcd.make_codec(name),
                                  D)
    v_ref, d_ref, _ = rcd.unpack_words_np(words, rcd.make_codec(name), D)
    t_words = tcd.words_to_torch(words, "cpu")
    assert t_words.dtype == torch.int32
    v, d = tcd.unpack_words_torch(t_words, tcd.make_codec(name), D)
    # value bits (NaN payloads included) and deltas
    np.testing.assert_array_equal(
        v.numpy().view(np.uint16 if v.dtype == torch.float16 else np.uint32),
        np.asarray(v_ref).view(np.uint16 if v_ref.dtype == np.float16
                               else np.uint32))
    np.testing.assert_array_equal(d.numpy(), d_ref.astype(np.int64))
    # numpy decode of the port equals the reference's too
    v2, d2, f2 = tcd.unpack_words_np(words, tcd.make_codec(name), D)
    np.testing.assert_array_equal(np.asarray(v2).view(np.uint8),
                                  np.asarray(v_ref).view(np.uint8))
    np.testing.assert_array_equal(d2, d_ref)


def test_words_roundtrip_int32_bits():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                     np.uint32)
    np.testing.assert_array_equal(
        tcd.words_to_numpy(tcd.words_to_torch(words, "cpu")), words)
    assert tcd.as_int32(0xFFFF0000) == -65536
    assert tcd.as_int32(5) == 5


@pytest.mark.parametrize("rule", ["negative", "flag1", "dummy"])
def test_pack_words_errors_match(rule):
    deltas, flags = {"negative": ([-1], [1]), "flag1": ([1 << 10], [1]),
                     "dummy": ([1 << 31], [0])}[rule]
    args = (np.zeros(1, F32), np.array(deltas), np.array(flags, np.uint8))
    with pytest.raises(ValueError) as ref:
        rcd.pack_words_np(*args, rcd.make_codec("fp16"), 4)
    with pytest.raises(ValueError) as got:
        tcd.pack_words_np(*args, tcd.make_codec("fp16"), 4)
    assert str(got.value) == str(ref.value)


def test_codec_registry_matches():
    for name in ("fp16", "bf16", "e8m", "fixed12", "fixed16"):
        r, t = rcd.make_codec(name), tcd.make_codec(name)
        assert (r.name, r.min_D, r.max_D) == (t.name, t.min_D, t.max_D)
        assert [r.value_bits(D) for D in range(1, 16)] == \
            [t.value_bits(D) for D in range(1, 16)]
    with pytest.raises(ValueError):
        tcd.make_codec("fp8")


def test_rne_truncate_matches_on_all_special_patterns():
    rng = np.random.default_rng(3)
    u = np.concatenate([rng.integers(0, 1 << 32, 20_000, dtype=np.uint64),
                        np.arange(0x7F7FFFF0, 0x7F800010),
                        np.arange(0xFF7FFFF0, 0x100000000)]).astype(np.uint32)
    for low in (1, 9, 16, 22, 23):
        np.testing.assert_array_equal(tcd._rne_truncate_f32_np(u, low),
                                      rcd._rne_truncate_f32_np(u, low))


def test_delta_helpers_match():
    deltas = np.array([5, (1 << 31) + 12345, (1 << 33) + 7, 1 << 40, 0, 3],
                      np.int64)
    for D in (1, 4, 15, 22):
        np.testing.assert_array_equal(tde.dummies_for_deltas(deltas, D),
                                      rde.dummies_for_deltas(deltas, D))
    nd = rde.dummies_for_deltas(deltas, 4)
    vals = np.arange(len(deltas), dtype=F32)
    for a, b in zip(tde.emit_word_stream(vals, deltas, nd),
                    rde.emit_word_stream(vals, deltas, nd)):
        np.testing.assert_array_equal(a, b)


def test_encode_rows_and_d0_match():
    rng = np.random.default_rng(4)
    n, m = 300, 5000
    counts = rng.integers(0, 9, n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(m, c, replace=False))
                              for c in counts]).astype(np.int64)
    assert tde.lower_bandwidth(indptr, indices, n) == \
        rde.lower_bandwidth(indptr, indices, n)
    k_left = rde.lower_bandwidth(indptr, indices, n)
    d0 = rde.d0_for_rows(n, 32, k_left)
    np.testing.assert_array_equal(tde.d0_for_rows(n, 32, k_left), d0)
    for D in (2, 8, 15):
        for a, b in zip(tde.encode_rows(indptr, indices, d0, D),
                        rde.encode_rows(indptr, indices, d0, D)):
            np.testing.assert_array_equal(a, b)
