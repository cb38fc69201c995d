"""Build and load the hand-written CUDA kernels of ``henbun_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into
``build/henbun_tpu_torch/<name>-<hash>.so`` beside the package, keyed by a
hash of the source, every header in ``csrc/`` (``*.cuh``, which the
sources include) and the flags, so an edit of either rebuilds it and an
unchanged source is built once. The library is loaded with ``ctypes``:
pointers and the stream go in as ``c_void_p``. Nothing here includes
PyTorch's headers (one such file takes minutes to build; a plain C file
seconds).

Nothing is built when this module is imported: ``load(name)`` builds at
first use, and ``build_all()`` builds every source at once, one ``nvcc``
process per file, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "henbun_tpu_torch")

# exact sqrt / divide: no --use_fast_math, and the kernels call
# __fsqrt_rn / __fdiv_rn; plain float FMA only, so nothing runs in TF32
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The CUDA compiler: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of henbun_tpu_torch are built at first use."
    )


def sources():
    """Names of the kernel sources in csrc/, without the .cu suffix."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def headers(csrc=CSRC):
    """The shared headers in csrc/ (``*.cuh``), sorted."""
    return sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))


def _target(name, csrc=CSRC, build_dir=BUILD_DIR):
    """(source path, library path): the library is named by a hash of the
    source, every header of csrc/ and the flags."""
    src = os.path.join(csrc, name + ".cu")
    digest = hashlib.sha256()
    for path in [src] + [os.path.join(csrc, h) for h in headers(csrc)]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(build_dir, "%s-%s.so" % (name, digest.hexdigest()[:16]))


def _start(name):
    """Start nvcc for one source; None when its library is already built."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name, started):
    """Wait for one nvcc; return its log. Raises if the build failed."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed (%d) on csrc/%s.cu:\n%s" % (proc.returncode, name, log)
        )
    os.replace(tmp, out)
    return log


def build_all():
    """Build every kernel source at once, one nvcc each, all running
    together. Returns {name: compiler log} ('' when the library was
    already built)."""
    names = sources()
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, started[n]) for n in names}


def load(name, symbol, argtypes):
    """The C function `symbol` of csrc/<name>.cu, with its ctypes argument
    types set and an int return (the launch's cudaError_t); the library is
    built at first use."""
    with _lock:
        fn = _libs.get((name, symbol))
        if fn is None:
            _finish(name, _start(name))
            fn = getattr(ctypes.CDLL(_target(name)[1]), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[(name, symbol)] = fn
        return fn
