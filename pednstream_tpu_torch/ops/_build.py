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

Every op launches through :func:`launch`: the entry point by name, on the
operands' device and its current stream, its error code checked, its
launch counted under one lock.  ``ENTRIES`` names each source and its
entry points' argument types.  Adding a kernel takes a source under
``csrc/``, its entry in ``ENTRIES`` and its op module under ``ops/``.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "pednstream_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
    "-Xcompiler", "-fPIC",
)

_LOCK = threading.RLock()
# guards the launch counts: simulations step from several threads at once
_COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# rings, avg_tt and its replica stride, gamma and its stride, tau_shockwave
# and its stride, out, B, H, E, t, the per-replica t (or null), unit_time,
# windowed
_NCURVE = [_P] * 4 + [_LL, _P, _LL, _P, _LL, _P] + [_I] * 4 + [_P, _F, _I]
# each source under csrc/ and its entry points, each with its arguments
# before the stream, which every one takes last
ENTRIES = {
    "ncurve.cu": {"ncurve_history_reads": _NCURVE, "ncurve_history_reads_f64": _NCURVE},
    # the argument block
    "routing.cu": {"routing_turning_fractions": [_P], "routing_turning_fractions_f64": [_P]},
    # nf, p, its period, u, z, out, n
    "binom.cu": {"binom_fast": [_P, _P, _LL, _P, _P, _P, _LL]},
    # the argument block
    "node_solve.cu": {"node_solve": [_P], "node_solve_f64": [_P]},
}
SOURCES = tuple(_PKG / "csrc" / name for name in ENTRIES)


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
    for entries in ENTRIES.values():
        for name, args in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = [*args, _P]
            fn.restype = _I
    return lib


def launch(op: str, entry: str, device: torch.device, *args, counts=()) -> None:
    """Calls the library's ``entry`` with ``args`` and the current stream
    of the CUDA ``device``, that device current meanwhile, and raises
    ``"<op> launch failed: CUDA error <n>"`` where it returns an error.
    Then adds one to each ``(table, key)`` of ``counts`` under one lock."""
    fn = getattr(library(), entry)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        for table, key in counts:
            table[key] += 1
