"""Build and load the port's CUDA kernels.

The sources under ``pednstream_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, which is loaded with ``ctypes``.  The library lands in
``build/pednstream_tpu_torch/`` at the root of the checkout (ignored by
git), under a name keyed on a hash of the sources and flags, so a changed
source builds anew and an unchanged one is reused.  A failed compile
raises with the compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "pednstream_tpu_torch"
SOURCES = (_PKG / "csrc" / "ncurve.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                           "or set CUDA_HOME")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile the sources if no library for their hash exists yet.
    Returns ``{"path", "seconds", "built", "log"}``: ``seconds`` is the
    compile time (0 when reused), ``log`` the compiler's output (ptxas
    register and spill counts)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libpednstream_kernels_{_digest()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "built": False, "log": log}
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(lib), "seconds": seconds, "built": True, "log": log}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(build()["path"])
    for fn in (lib.ncurve_fused_history_reads, lib.ncurve_fused_history_reads_f64):
        fn.argtypes = [_P] * 10 + [_I] * 3 + [_P]
        fn.restype = _I
    return lib
