"""Build and load the port's CUDA kernels.

The sources under ``pednstream_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a``, one compiler per source, all started
together, and linked into one shared library with a plain C interface,
which is loaded with ``ctypes``.  The library lands in
``build/pednstream_tpu_torch/`` at the root of the checkout (ignored by
git), under a name keyed on a hash of the sources and flags, so a changed
source builds anew and an unchanged one is reused.  A failed compile
raises with the compiler's output.  Building and loading are serialized by
a lock, so threads that reach a kernel together for the first time (a
threaded server's first requests) compile and load it once.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "pednstream_tpu_torch"
SOURCES = tuple(_PKG / "csrc" / name
                for name in ("ncurve.cu", "routing.cu", "binom.cu", "node_solve.cu"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
    "-Xcompiler", "-fPIC",
)

_LOCK = threading.RLock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


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


def _run(cmds: list) -> str:
    """Runs the commands at the same time; returns their output, or raises
    with the output of those that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    failed = [f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}" for cmd, log, rc in logs if rc]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log for _, log, _ in logs)


def build() -> dict:
    """Compile the sources if no library for their hash exists yet.
    Returns ``{"path", "seconds", "built", "log"}``: ``seconds`` is the
    compile time (0 when reused), ``log`` the compilers' output (ptxas
    register and spill counts).  Done once per process."""
    with _LOCK:
        return _build()


@functools.lru_cache(maxsize=None)
def _build() -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libpednstream_kernels_{_digest()}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "built": False, "log": log}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(SOURCES, objs)])
        out = str(Path(tmp) / lib.name)
        log += _run([[nvcc, "-shared", "-o", out, *objs]])
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(out, lib)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(lib), "seconds": seconds, "built": True, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set.
    Loaded once per process."""
    with _LOCK:
        return _library()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    for fn in (lib.ncurve_history_reads, lib.ncurve_history_reads_f64):
        # rings, avg_tt and its replica stride, gamma and its stride,
        # tau_shockwave and its stride, out, B, H, E, t, the per-replica
        # t (or null), unit_time, windowed, stream
        fn.argtypes = [_P] * 4 + [_LL, _P, _LL, _P, _LL, _P] + [_I] * 4 + [_P, _F, _I, _P]
    for fn in (lib.routing_turning_fractions, lib.routing_turning_fractions_f64):
        fn.argtypes = [_P, _P]  # the argument block, stream
    # nf, p, its period, u, z, out, n, stream
    lib.binom_fast.argtypes = [_P, _P, _LL, _P, _P, _P, _LL, _P]
    for fn in (lib.node_solve, lib.node_solve_f64):
        fn.argtypes = [_P, _P]  # the argument block, stream
    for fn in (lib.ncurve_history_reads, lib.ncurve_history_reads_f64,
               lib.routing_turning_fractions, lib.routing_turning_fractions_f64,
               lib.binom_fast, lib.node_solve, lib.node_solve_f64):
        fn.restype = _I
    return lib
