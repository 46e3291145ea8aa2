"""The PackSELL SpMV kernels and their plain PyTorch versions.

Fused stream (the plan engine's repacked ``[G, wr, C]`` words with one
int32 checkpoint per group lane; the plan applies the level-chain tail
and the inverse-permutation gather):

* K1 ``packsell_spmv_fused`` → group partials ``[G, C]``;
* K3 ``packsell_spmm_fused`` → ``[G, C, nb]``, each word loaded and
  decoded once for up to 8 right-hand sides.

Width buckets (canonical words ``[S, w, C]``, a column cursor per stored
row), each one launch over all buckets of a plan through a
:class:`BucketTable` built once with the plan:

* K4 ``packsell_spmv_buckets`` → ``[total_stored]``, the full-x SpMV;
* K6 ``packsell_spmv_band_buckets`` → ``[total_stored]``, the SpMV with
  x cut to a ``2·hw`` window per block of ``sb`` slices;
* K5 ``packsell_spmm_buckets`` → ``[total_stored, nb]``, the multi-RHS
  SpMV, each word loaded and decoded once for up to 8 right-hand sides.

A row's words fall in width blocks of ``wb``; each block's sum starts at
+0 and the blocks are added in wi order (:func:`sum_width_partials`). The
carry body (no checkpoints) is one block of all ``w`` words from
``d0[s]``. The kernels walk a row's blocks in one thread, its cursor
carried from ``d0``. The per-bucket plain versions
(``packsell_spmv_bucket_plain``, ``packsell_spmv_band_bucket_plain``,
``packsell_spmm_bucket_plain``) seed each block from ``ckpt[s, wi, c]``
and return partials ``[nw, S, C(, nb)]``; the all-bucket plain versions
add them and concatenate the buckets.

They replace the Pallas kernels of ``repro/kernels/packsell_spmv.py`` of
the same names (bodies ``_kernel_fused``/``_kernel_fused_mm``,
``_kernel_full``/``_kernel_full_ckpt``, ``_kernel_band``/
``_kernel_band_ckpt``, ``_kernel_spmm``/``_kernel_spmm_ckpt``). Each
wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel (``csrc/packsell_fused.cu``, ``csrc/packsell_bucket.cu``)
or raises. Both versions add in the same order with no fused
multiply-add, so on the card they agree bit for bit. K1, K3, K4 and K5
clamp columns to ``[0, m-1]`` (the jnp bodies' rule); K6 keeps the
reference's zero-padded window (see the notes in the CUDA sources). The
bound on the H100 is bytes: the words are read once, coalesced across
lanes, and x is gathered from L2. ``launches`` on each wrapper counts the
kernel launches it made.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..core import codecs as cd
from ..core.packsell import _nonempty
from . import _build

ENCODINGS = {"f16": 0, "top16": 1, "fixed16": 2, "words": 3}


def _codec_id(codec_name: str) -> int:
    if codec_name.startswith("fixed"):
        return 3
    return {"fp16": 0, "bf16": 1, "e8m": 2}[codec_name]


def fused_decode_word(w: torch.Tensor, codec: cd.Codec, D: int,
                      encoding: str, scale: float):
    """(value float32, run-local column offset int64) of fused-stream
    words. The 16/16 split encodings are two fixed shifts; ``'words'`` is
    the canonical branch-free unpack with the delta field already
    rewritten to the re-based offset."""
    if encoding == "f16":
        v = (w >> 16).to(torch.int16).view(torch.float16)
        local = w & 0xFFFF
    elif encoding == "top16":
        v = (w & cd.as_int32(0xFFFF0000)).view(torch.float32)
        local = w & 0xFFFF
    elif encoding == "fixed16":
        v = (w >> 16).to(torch.float32) * scale
        local = w & 0xFFFF
    elif encoding == "words":
        v, local = cd.unpack_words_torch(w, codec, D)
    else:
        raise ValueError(f"unknown fused encoding {encoding!r}")
    return v.to(torch.float32), local.to(torch.int64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def packsell_spmv_fused_plain(words3d: torch.Tensor, ckpt: torch.Tensor,
                              x: torch.Tensor, *, codec_name: str, D: int,
                              encoding: str, scale: float = 0.0
                              ) -> torch.Tensor:
    """Group partials [G, C]: decode the whole stream, add the
    checkpoints, gather x clamped to [0, m-1], then add the products in
    word order starting from the first."""
    G, wr, C = words3d.shape
    if G == 0:
        return torch.zeros((0, C), dtype=torch.float32, device=x.device)
    xc = _nonempty(x.to(torch.float32))
    v, local = fused_decode_word(words3d, cd.make_codec(codec_name), D,
                                 encoding, scale)
    cols = (ckpt.to(torch.int64)[:, None, :] + local).clamp_(
        0, xc.shape[0] - 1)
    p = v * xc[cols]
    acc = p[:, 0, :]
    for j in range(1, wr):
        acc = acc + p[:, j, :]
    return acc


def packsell_spmm_fused_plain(words3d: torch.Tensor, ckpt: torch.Tensor,
                              x: torch.Tensor, *, codec_name: str, D: int,
                              encoding: str, scale: float = 0.0
                              ) -> torch.Tensor:
    """Multi-RHS group partials [G, C, nb] for x: [m, nb]; per word
    position one decode, one [G, C, nb] gather and one add."""
    G, wr, C = words3d.shape
    nb = x.shape[1]
    if G == 0:
        return torch.zeros((0, C, nb), dtype=torch.float32, device=x.device)
    xc = _nonempty(x.to(torch.float32))
    codec = cd.make_codec(codec_name)
    ck = ckpt.to(torch.int64)
    acc = None
    for j in range(wr):
        v, local = fused_decode_word(words3d[:, j, :], codec, D, encoding,
                                     scale)
        t = v[..., None] * xc[(ck + local).clamp_(0, xc.shape[0] - 1)]
        acc = t if acc is None else acc + t
    return acc


def _bucket_walk(pack: torch.Tensor, d0: torch.Tensor, ckpt, codec_name: str,
                 D: int, wb: int):
    """Decode one bucket: ``(v float32 [S, w, C], cursor int64 [S, w, C],
    wb, nw)``, the cursor taken after each word's delta. The carry body
    seeds it from ``d0[s]`` (one block of all ``w`` words); the checkpoint
    body seeds block ``wi`` from ``ckpt[s, wi, c]``."""
    S, w, C = pack.shape
    v, d = cd.unpack_words_torch(pack, cd.make_codec(codec_name), D)
    csum = torch.cumsum(d, dim=1)
    if ckpt is None:
        return (v.to(torch.float32),
                d0.to(torch.int64)[:, None, None] + csum, max(w, 1), 1)
    nw = -(-w // wb)
    if tuple(ckpt.shape) != (S, nw, C):
        raise ValueError(f"checkpoints {tuple(ckpt.shape)} do not fit pack "
                         f"{tuple(pack.shape)} at wb={wb} (want {(S, nw, C)})")
    blk = torch.arange(w, device=pack.device) // wb
    start = (csum - d)[:, ::wb, :]          # delta sum before each block
    cur = ckpt.to(torch.int64)[:, blk, :] + csum - start[:, blk, :]
    return v.to(torch.float32), cur, wb, nw


def _block_sums(p: torch.Tensor, wb: int, nw: int) -> torch.Tensor:
    """Products ``[S, w, C(, nb)]`` → partials ``[nw, S, C(, nb)]``: per
    width block, a sum in j order from 0. The zeros that fill the last
    block add +0, which changes no sum (one that starts at +0 is never
    -0), so this equals a walk that stops at word ``w``."""
    S, w = p.shape[:2]
    tail = tuple(p.shape[2:])
    if nw * wb > w:
        p = torch.cat([p, p.new_zeros((S, nw * wb - w) + tail)], dim=1)
    p = p.reshape((S, nw, wb) + tail)
    acc = p.new_zeros((S, nw) + tail)
    for jj in range(wb):
        acc = acc + p[:, :, jj]
    return acc.transpose(0, 1).contiguous()


def sum_width_partials(part: torch.Tensor) -> torch.Tensor:
    """``[nw, S, C(, nb)]`` → ``[S, C(, nb)]``: the width-block partials of
    a checkpoint body added in wi order. The plan applies this one function
    to a kernel's partials and to its plain version's alike."""
    if part.shape[0] == 0:
        return part.new_zeros(part.shape[1:])
    acc = part[0]
    for wi in range(1, part.shape[0]):
        acc = acc + part[wi]
    return acc


def packsell_spmv_bucket_plain(pack: torch.Tensor, d0: torch.Tensor,
                               x: torch.Tensor, *, codec_name: str, D: int,
                               wb: int = 32, ckpt=None) -> torch.Tensor:
    """One bucket's stored-row outputs ``[S, C]`` (carry body) or width-block
    partials ``[nw, S, C]`` (``ckpt`` given), columns clamped to [0, m-1]."""
    xc = _nonempty(x.to(torch.float32))
    v, cur, wb, nw = _bucket_walk(pack, d0, ckpt, codec_name, D, wb)
    part = _block_sums(v * xc[cur.clamp(0, xc.shape[0] - 1)], wb, nw)
    return part if ckpt is not None else part[0]


@dataclasses.dataclass(frozen=True)
class BucketTable:
    """Where the buckets of one K4, K5 or K6 launch lie, built once with a
    ``full`` or ``band`` plan by :func:`bucket_table`. ``rows`` is int64
    ``[nbk, 10]`` on the buckets' device, one row per bucket with stored
    rows: the addresses of its words and d0, ``S``, ``w``, ``wb``, ``nw``,
    its first output row, its first thread block, the address of its band
    windows (0 without them) and ``sb`` (the columns ``TableCol`` of
    ``csrc/packsell_bucket.cu``). ``wbs``, ``sbs`` and ``carry`` are what
    the plain versions need; ``operands`` are the word and d0 addresses and
    the shape per bucket, and ``win_ptrs`` the window addresses (None
    without windows), which the wrappers hold against the tensors they are
    given."""

    rows: torch.Tensor
    wbs: tuple
    sbs: tuple
    carry: bool
    operands: tuple
    win_ptrs: Optional[tuple]
    total: int
    blocks: int


#: threads per block of the bucket kernels (``kThreads`` in
#: packsell_bucket.cu)
_BUCKET_THREADS = 256
#: int64 columns per bucket of the device table (``kTableCols``)
_TABLE_COLS = 10


def bucket_table(packs, d0s, kckpts, wbs, wins=None, sbs=None
                 ) -> BucketTable:
    """The :class:`BucketTable` of the bucket kernels over ``packs``
    (``kckpts`` None: the carry body, one width block of ``w`` words per
    row; else blocks of ``wbs[b]`` words). ``wins`` (int32 per bucket, from
    ``plan.band_plan``) and ``sbs`` (slices per window, default 8) give K6
    its windows."""
    carry = kckpts is None
    sbs = tuple(int(v) for v in (sbs or (8,) * len(packs)))
    rows = []
    out = blk = 0
    for b, (pack, d0, wb) in enumerate(zip(packs, d0s, wbs)):
        S, w, C = pack.shape
        bwb, nw = (w, 1) if carry else (int(wb), -(-w // int(wb)))
        if S * C:
            win = 0
            if wins is not None:
                if wins[b].dtype != torch.int32 \
                        or wins[b].numel() < -(-S // sbs[b]):
                    raise ValueError(
                        f"bucket_table: bucket {b} needs int32 windows for "
                        f"{S} slices at sb={sbs[b]} (got {wins[b].numel()} "
                        f"{wins[b].dtype})")
                win = wins[b].data_ptr()
            rows.append([pack.data_ptr(), d0.data_ptr(), S, w, bwb, nw, out,
                         blk, win, sbs[b]])
        out += S * C
        blk += -(-S * C // _BUCKET_THREADS)
    dev = packs[0].device if packs else torch.device("cpu")
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, _TABLE_COLS)
    return BucketTable(rows=table.to(dev), wbs=tuple(int(w) for w in wbs),
                       sbs=sbs, carry=carry, operands=_operands(packs, d0s),
                       win_ptrs=None if wins is None else _win_ptrs(wins),
                       total=out, blocks=blk)


def _operands(packs, d0s) -> tuple:
    return tuple((p.data_ptr(), d.data_ptr(), tuple(p.shape))
                 for p, d in zip(packs, d0s))


def _win_ptrs(wins) -> tuple:
    return tuple((w.data_ptr(), w.numel()) for w in wins)


def _bucket_cat(parts, x: torch.Tensor) -> torch.Tensor:
    """Per-bucket outputs ``[S, C(, nb)]`` → ``[total_stored(, nb)]``."""
    tail = tuple(x.shape[1:])
    parts = [t.reshape((-1,) + tail) for t in parts]
    if not parts:
        return torch.zeros((0,) + tail, dtype=torch.float32, device=x.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _summed(t: torch.Tensor, ck) -> torch.Tensor:
    return t if ck is None else sum_width_partials(t)


def packsell_spmv_buckets_plain(packs, d0s, kckpts, table: BucketTable,
                                x: torch.Tensor, *, codec_name: str,
                                D: int) -> torch.Tensor:
    """K4's plain version: every bucket's plain SpMV, its checkpoint
    partials added by :func:`sum_width_partials`, concatenated in bucket
    order: ``[total_stored]``."""
    parts = []
    for b, (pack, d0) in enumerate(zip(packs, d0s)):
        ck = None if kckpts is None else kckpts[b]
        parts.append(_summed(packsell_spmv_bucket_plain(
            pack, d0, x, codec_name=codec_name, D=D, wb=table.wbs[b],
            ckpt=ck), ck))
    return _bucket_cat(parts, x)


def packsell_spmv_band_bucket_plain(pack: torch.Tensor, d0: torch.Tensor,
                                    win: torch.Tensor, x: torch.Tensor, *,
                                    codec_name: str, D: int, hw: int,
                                    sb: int = 8, wb: int = 32,
                                    ckpt=None) -> torch.Tensor:
    """K6's plain version: as :func:`packsell_spmv_bucket_plain`, but slice
    ``s`` reads x through the window at ``base = win[s // sb] · hw``:
    ``x[base + clip(cur - base, 0, 2hw-1)]``, and 0 at and past m (the
    reference's x zero-padded by ``(-m) % hw + hw``)."""
    xc = _nonempty(x.to(torch.float32))
    m = xc.shape[0]
    v, cur, wb, nw = _bucket_walk(pack, d0, ckpt, codec_name, D, wb)
    S = pack.shape[0]
    base = (win.to(torch.int64)[torch.arange(S, device=pack.device) // sb]
            * hw)[:, None, None]
    g = base + (cur - base).clamp(0, 2 * hw - 1)
    xv = torch.where(g < m, xc[g.clamp(max=m - 1)], xc.new_zeros(()))
    part = _block_sums(v * xv, wb, nw)
    return part if ckpt is not None else part[0]


def packsell_spmv_band_buckets_plain(packs, d0s, wins, kckpts,
                                     table: BucketTable, x: torch.Tensor, *,
                                     codec_name: str, D: int,
                                     hw: int) -> torch.Tensor:
    """K6's plain version: every bucket's plain band SpMV, its checkpoint
    partials added by :func:`sum_width_partials`, concatenated in bucket
    order: ``[total_stored]``."""
    parts = []
    for b, (pack, d0) in enumerate(zip(packs, d0s)):
        ck = None if kckpts is None else kckpts[b]
        parts.append(_summed(packsell_spmv_band_bucket_plain(
            pack, d0, wins[b], x, codec_name=codec_name, D=D, hw=hw,
            sb=table.sbs[b], wb=table.wbs[b], ckpt=ck), ck))
    return _bucket_cat(parts, x)


def packsell_spmm_bucket_plain(pack: torch.Tensor, d0: torch.Tensor,
                               x: torch.Tensor, *, codec_name: str, D: int,
                               wb: int = 32, ckpt=None) -> torch.Tensor:
    """K5's plain version for x: [m, nb]: ``[S, C, nb]`` (carry body) or
    partials ``[nw, S, C, nb]``."""
    xc = _nonempty(x.to(torch.float32))
    v, cur, wb, nw = _bucket_walk(pack, d0, ckpt, codec_name, D, wb)
    part = _block_sums(v[..., None] * xc[cur.clamp(0, xc.shape[0] - 1)],
                       wb, nw)
    return part if ckpt is not None else part[0]


def packsell_spmm_buckets_plain(packs, d0s, kckpts, table: BucketTable,
                                x: torch.Tensor, *, codec_name: str,
                                D: int) -> torch.Tensor:
    """K5's plain version for x: [m, nb]: every bucket's plain SpMM, its
    checkpoint partials added by :func:`sum_width_partials`, concatenated
    in bucket order: ``[total_stored, nb]``."""
    parts = []
    for b, (pack, d0) in enumerate(zip(packs, d0s)):
        ck = None if kckpts is None else kckpts[b]
        parts.append(_summed(packsell_spmm_bucket_plain(
            pack, d0, x, codec_name=codec_name, D=D, wb=table.wbs[b],
            ckpt=ck), ck))
    return _bucket_cat(parts, x)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = _build.load("packsell_fused")
    if not getattr(lib, "_typed", False):
        lib.packsell_spmv_fused.argtypes = [_P, _P, _P, _P, _L, _I, _I, _L,
                                            _I, _I, _I, ctypes.c_float, _P]
        lib.packsell_spmv_fused.restype = _I
        lib.packsell_spmm_fused.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I,
                                            _I, _L, _I, _I, _I,
                                            ctypes.c_float, _P]
        lib.packsell_spmm_fused.restype = _I
        lib._typed = True
    return lib


def _check_operands(words3d, ckpt, x, xdim: int, what: str) -> None:
    dev = words3d.device
    if dev.type != "cuda" or ckpt.device != dev or x.device != dev:
        raise ValueError(f"{what}: words3d, ckpt and x must lie on one CUDA "
                         f"device (got {dev}, {ckpt.device}, {x.device})")
    if words3d.dtype != torch.int32 or ckpt.dtype != torch.int32:
        raise TypeError(f"{what}: words3d and ckpt must be int32 (got "
                        f"{words3d.dtype}, {ckpt.dtype})")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x must be float32 (got {x.dtype})")
    G, wr, C = words3d.shape
    if tuple(ckpt.shape) != (G, C) or x.dim() != xdim:
        raise ValueError(f"{what}: shapes words3d {tuple(words3d.shape)}, "
                         f"ckpt {tuple(ckpt.shape)}, x {tuple(x.shape)} do "
                         "not fit")
    if not (words3d.is_contiguous() and ckpt.is_contiguous()
            and x.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")


def _scale_arg(codec_name: str, encoding: str, scale: float) -> float:
    """The kernel's ``scale``: the fixed16 dequant scale, or 2^-frac for
    canonical fixed-point words."""
    if encoding == "words" and codec_name.startswith("fixed"):
        return 2.0 ** -int(codec_name[len("fixed"):])
    return float(scale)


def packsell_spmv_fused(words3d: torch.Tensor, ckpt: torch.Tensor,
                        x: torch.Tensor, *, codec_name: str, D: int,
                        encoding: str, scale: float = 0.0) -> torch.Tensor:
    """K1: group partials [G, C] float32 of the fused stream. CPU tensors
    take :func:`packsell_spmv_fused_plain`; CUDA tensors launch the
    kernel."""
    if words3d.device.type == "cpu":
        return packsell_spmv_fused_plain(words3d, ckpt, x,
                                         codec_name=codec_name, D=D,
                                         encoding=encoding, scale=scale)
    _check_operands(words3d, ckpt, x, 1, "packsell_spmv_fused")
    G, wr, C = words3d.shape
    part = torch.empty((G, C), dtype=torch.float32, device=words3d.device)
    if G == 0:
        return part
    xc = _nonempty(x)
    with torch.cuda.device(words3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().packsell_spmv_fused(
            words3d.data_ptr(), ckpt.data_ptr(), xc.data_ptr(),
            part.data_ptr(), G, wr, C, xc.shape[0], ENCODINGS[encoding],
            _codec_id(codec_name), D,
            _scale_arg(codec_name, encoding, scale), stream)
    packsell_spmv_fused.launches += 1
    _build.check(rc, "packsell_spmv_fused")
    return part


packsell_spmv_fused.launches = 0


def spmm_vector_loads(x: torch.Tensor) -> bool:
    """Whether K3 reads x: [m, nb] with 16-byte loads (and writes its
    output with 16-byte stores): nb % 4 == 0 and x 16-byte aligned; the
    output is a fresh allocation, so it is aligned."""
    return x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0


def packsell_spmm_fused(words3d: torch.Tensor, ckpt: torch.Tensor,
                        x: torch.Tensor, *, codec_name: str, D: int,
                        encoding: str, scale: float = 0.0) -> torch.Tensor:
    """K3: multi-RHS group partials [G, C, nb] float32 for x: [m, nb], each
    word decoded once for up to 8 right-hand sides (chunks of 8 on a second
    grid axis; :func:`spmm_vector_loads` picks the X loads). CPU tensors
    take :func:`packsell_spmm_fused_plain`; CUDA tensors launch the
    kernel."""
    if words3d.device.type == "cpu":
        return packsell_spmm_fused_plain(words3d, ckpt, x,
                                         codec_name=codec_name, D=D,
                                         encoding=encoding, scale=scale)
    _check_operands(words3d, ckpt, x, 2, "packsell_spmm_fused")
    G, wr, C = words3d.shape
    nb = x.shape[1]
    if G * C >= 1 << 31:
        raise ValueError(f"packsell_spmm_fused: {G * C} group lanes do not "
                         "fit the kernel's 32-bit thread index")
    part = torch.empty((G, C, nb), dtype=torch.float32,
                       device=words3d.device)
    if G == 0 or nb == 0:
        return part
    xc = _nonempty(x)
    vec = spmm_vector_loads(xc)
    with torch.cuda.device(words3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().packsell_spmm_fused(
            words3d.data_ptr(), ckpt.data_ptr(), xc.data_ptr(),
            part.data_ptr(), G, wr, C, nb, int(vec), xc.shape[0],
            ENCODINGS[encoding], _codec_id(codec_name), D,
            _scale_arg(codec_name, encoding, scale), stream)
    packsell_spmm_fused.launches += 1
    _build.check(rc, "packsell_spmm_fused")
    return part


packsell_spmm_fused.launches = 0


def _bucket_lib() -> ctypes.CDLL:
    lib = _build.load("packsell_bucket")
    if not getattr(lib, "_typed", False):
        lib.packsell_spmv_buckets.argtypes = [_P, _I, _I, _I, _P, _P, _L, _I,
                                              _I, ctypes.c_float, _P]
        lib.packsell_spmv_buckets.restype = _I
        lib.packsell_spmv_band_buckets.argtypes = [
            _P, _I, _I, _I, _P, _P, _L, _I, _I, _I, ctypes.c_float, _P]
        lib.packsell_spmv_band_buckets.restype = _I
        lib.packsell_spmm_buckets.argtypes = [_P, _I, _I, _I, _P, _P, _I, _I,
                                              _L, _I, _I, ctypes.c_float, _P]
        lib.packsell_spmm_buckets.restype = _I
        lib._typed = True
    return lib


def _check_table(what: str, packs, d0s, kckpts, table: BucketTable,
                 wins=None) -> None:
    """Raise unless ``table`` was built for these tensors (and ``wins``)
    and this body; both the kernel and the plain version read it."""
    if _operands(packs, d0s) != table.operands \
            or (kckpts is None) != table.carry:
        raise ValueError(f"{what}: the table was built for other buckets "
                         "(or the other body)")
    if wins is not None and (table.win_ptrs is None
                             or _win_ptrs(wins) != table.win_ptrs):
        raise ValueError(f"{what}: the table was built for other windows")


def _check_buckets(what: str, packs, d0s, kckpts, table: BucketTable,
                   x: torch.Tensor, xdim: int, wins=None, hw: int = 0
                   ) -> None:
    """Raise unless the operands and ``table`` lie on x's CUDA device,
    the table was built for them (:func:`_check_table`) and x fits the
    kernels' 32-bit cursor, window and row index."""
    dev = x.device
    if dev.type != "cuda" or table.rows.device != dev or any(
            t.device != dev for t in (*packs, *d0s, *(wins or ()))):
        raise ValueError(f"{what}: packs, d0s, table and x must lie on one "
                         f"CUDA device (x on {dev}, table on "
                         f"{table.rows.device})")
    if x.dtype != torch.float32 or x.dim() != xdim or not x.is_contiguous():
        raise TypeError(f"{what}: x must be contiguous {xdim}-D float32 (got "
                        f"{x.dtype}, {tuple(x.shape)})")
    _check_table(what, packs, d0s, kckpts, table, wins)
    reach = max(x.shape[0], table.total) + 2 * hw
    if reach >= 1 << 31:
        raise ValueError(f"{what}: the kernel's 32-bit cursor, window and row "
                         f"index need max(m, stored rows) + 2·hw < 2^31 (m = "
                         f"{x.shape[0]}, rows = {table.total}, hw = {hw})")


def _launch(what: str, fn, table: BucketTable, x: torch.Tensor, *args):
    """Launch ``fn(table, nbk, blocks, C, x, *args, stream)`` on x's device
    and raise on a CUDA error."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.rows.data_ptr(), table.rows.shape[0], table.blocks,
                table.operands[0][2][2], x.data_ptr(), *args, stream)
    _build.check(rc, what)


def packsell_spmv_buckets(packs, d0s, kckpts, table: BucketTable,
                          x: torch.Tensor, *, codec_name: str,
                          D: int) -> torch.Tensor:
    """K4: the SpMV of all buckets ``[total_stored]`` float32, in one
    launch through ``table`` (:func:`bucket_table` of the same tensors).
    ``kckpts`` (int32 ``[S, nw, C]`` per bucket, or None for the carry
    body) fixes the width blocks of the sum; the kernel carries each row's
    cursor from ``d0`` and does not read them. CPU tensors take
    :func:`packsell_spmv_buckets_plain`; CUDA tensors launch the kernel."""
    what = "packsell_spmv_buckets"
    if x.device.type == "cpu":
        _check_table(what, packs, d0s, kckpts, table)
        return packsell_spmv_buckets_plain(packs, d0s, kckpts, table, x,
                                           codec_name=codec_name, D=D)
    _check_buckets(what, packs, d0s, kckpts, table, x, 1)
    y = torch.empty((table.total,), dtype=torch.float32, device=x.device)
    if table.total == 0:
        return y
    xc = _nonempty(x)
    packsell_spmv_buckets.launches += 1
    _launch(what, _bucket_lib().packsell_spmv_buckets, table, xc,
            y.data_ptr(), xc.shape[0], _codec_id(codec_name), D,
            _scale_arg(codec_name, "words", 0.0))
    return y


packsell_spmv_buckets.launches = 0


def packsell_spmv_band_buckets(packs, d0s, wins, kckpts, table: BucketTable,
                               x: torch.Tensor, *, codec_name: str, D: int,
                               hw: int) -> torch.Tensor:
    """K6: the band SpMV of all buckets ``[total_stored]`` float32, in one
    launch through ``table`` (:func:`bucket_table` of the same tensors and
    ``wins``): slice ``s`` of bucket ``b`` reads x through the ``2·hw``
    window that starts at ``wins[b][s // sb] · hw``, and 0 at and past m.
    CPU tensors take :func:`packsell_spmv_band_buckets_plain`; CUDA tensors
    launch the kernel."""
    what = "packsell_spmv_band_buckets"
    if x.device.type == "cpu":
        _check_table(what, packs, d0s, kckpts, table, wins)
        return packsell_spmv_band_buckets_plain(
            packs, d0s, wins, kckpts, table, x, codec_name=codec_name, D=D,
            hw=hw)
    _check_buckets(what, packs, d0s, kckpts, table, x, 1, wins, hw)
    y = torch.empty((table.total,), dtype=torch.float32, device=x.device)
    if table.total == 0:
        return y
    xc = _nonempty(x)
    packsell_spmv_band_buckets.launches += 1
    _launch(what, _bucket_lib().packsell_spmv_band_buckets, table, xc,
            y.data_ptr(), xc.shape[0], hw, _codec_id(codec_name), D,
            _scale_arg(codec_name, "words", 0.0))
    return y


packsell_spmv_band_buckets.launches = 0


def packsell_spmm_buckets(packs, d0s, kckpts, table: BucketTable,
                          x: torch.Tensor, *, codec_name: str,
                          D: int) -> torch.Tensor:
    """K5: the SpMM of all buckets ``[total_stored, nb]`` float32 for x:
    [m, nb], in one launch through ``table`` (:func:`bucket_table` of the
    same tensors), each word decoded once for up to 8 right-hand sides
    (chunks of 8 on a second grid axis; :func:`spmm_vector_loads` picks the
    X loads). CPU tensors take :func:`packsell_spmm_buckets_plain`; CUDA
    tensors launch the kernel."""
    what = "packsell_spmm_buckets"
    if x.device.type == "cpu":
        _check_table(what, packs, d0s, kckpts, table)
        return packsell_spmm_buckets_plain(packs, d0s, kckpts, table, x,
                                           codec_name=codec_name, D=D)
    _check_buckets(what, packs, d0s, kckpts, table, x, 2)
    nb = x.shape[1]
    y = torch.empty((table.total, nb), dtype=torch.float32, device=x.device)
    if table.total == 0 or nb == 0:
        return y
    xc = _nonempty(x)
    packsell_spmm_buckets.launches += 1
    _launch(what, _bucket_lib().packsell_spmm_buckets, table, xc,
            y.data_ptr(), nb, int(spmm_vector_loads(xc)), xc.shape[0],
            _codec_id(codec_name), D, _scale_arg(codec_name, "words", 0.0))
    return y


packsell_spmm_buckets.launches = 0
