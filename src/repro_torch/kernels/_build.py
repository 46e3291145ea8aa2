"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the source, the shared ``*.cuh`` headers
and the flags, at first use.
:func:`build_all` starts one ``nvcc`` per source, all at once. A missing
``nvcc`` or a failed build raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("packsell_fused", "packsell_bucket", "sell_spmv", "row_dots")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels of repro_torch cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # the shared includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    ``(process | None, tmp path, target path)``."""
    out = _target(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _wait(proc, tmp: Path, out: Path):
    """Wait for nvcc; returns ``(log, error or None)``. The log of a build
    is kept beside its library, so a library built earlier returns it."""
    log_file = out.with_suffix(".log")
    if proc is None:
        return (log_file.read_text() if log_file.exists() else ""), None
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return log, f"exit {proc.returncode}"
    log_file.write_text(log)
    os.replace(tmp, out)        # atomic: concurrent loaders never see half a file
    return log, None


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, err = _wait(proc, tmp, out)
    if err:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu ({err}):\n{log}")
    return log


def build_all() -> dict:
    """Build every source concurrently (one nvcc each) and wait for all of
    them; returns the compiler logs by name (with ``-Xptxas -v``: each
    kernel's registers and spills) or raises naming every source that
    failed."""
    started = {name: _start(name) for name in SOURCES}
    done = {name: _wait(*args) for name, args in started.items()}
    failed = {name: r for name, r in done.items() if r[1]}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"csrc/{name}.cu ({err}):\n{log}"
            for name, (log, err) in failed.items()))
    return {name: log for name, (log, _) in done.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            proc, tmp, out = _start(name)
            _finish(name, proc, tmp, out)
            lib = ctypes.CDLL(str(out))
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
