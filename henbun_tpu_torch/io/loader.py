"""Python bindings for the C++ out-of-core minibatch loader.

Binds ``io/csrc/dataloader.cpp`` through ctypes. The shared library is
built with ``g++`` at first use into ``build/henbun_tpu_torch/`` beside
the package (the kernels' build directory, ``ops/_build.py``), named by a
hash of the source and the flags; nothing is written next to the source.

The row file format is the JAX package's: either package reads the
other's files byte for byte. See :class:`OutOfCoreLoader` and
:func:`henbun_tpu_torch.io.streaming.optimize_streaming`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "dataloader.cpp")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LIB = None
_LOCK = threading.Lock()


def library_path():
    """Where the built loader library lives: named by a hash of the source
    and the compiler flags, so an edit of either rebuilds it."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, "dataloader-%s.so" % digest.hexdigest()[:16])


def _build(out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    res = subprocess.run(["g++"] + GXX_FLAGS + [SOURCE, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("g++ failed (%d) on %s:\n%s%s"
                           % (res.returncode, SOURCE, res.stdout, res.stderr))
    os.replace(tmp, out)


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = library_path()
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
        lib.hb_loader_open.restype = ctypes.c_void_p
        lib.hb_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.hb_loader_next.restype = ctypes.POINTER(ctypes.c_float)
        lib.hb_loader_next.argtypes = [ctypes.c_void_p]
        lib.hb_loader_release.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.hb_loader_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def write_dataset(path, *arrays):
    """Write arrays (same leading dim) as one row-major binary file of
    concatenated 4-byte-element rows; returns
    (n_rows, row_floats, column slices, column dtypes).

    Float arrays are stored as float32. Integer and bool arrays are stored
    as int32 BIT PATTERNS inside the float32 row (the loader only memcpys
    4-byte lanes, so the bits round-trip exactly); recover them with
    :func:`read_columns`.
    """
    n = np.shape(arrays[0])[0]
    flat, dtypes = [], []
    for a in arrays:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
            f = np.ascontiguousarray(a, dtype=np.int32).reshape(n, -1)
            flat.append(f.view(np.float32))
            dtypes.append(np.dtype(np.int32))
        else:
            flat.append(np.ascontiguousarray(a, dtype=np.float32).reshape(n, -1))
            dtypes.append(np.dtype(np.float32))
    if any(f.shape[0] != n for f in flat):
        raise ValueError("arrays differ in their leading dimension")
    rows = np.concatenate(flat, axis=1)
    rows.tofile(path)
    slices, off = [], 0
    for f in flat:
        slices.append((off, off + f.shape[1]))
        off += f.shape[1]
    return n, rows.shape[1], slices, dtypes


def read_columns(batch, slices, dtypes=None):
    """Split a loader megabatch [rows, row_floats] back into the columns
    written by :func:`write_dataset`, reinterpreting int columns from their
    stored bit patterns."""
    out = []
    for i, (a, b) in enumerate(slices):
        col = batch[:, a:b]
        if dtypes is not None and dtypes[i] == np.dtype(np.int32):
            col = np.ascontiguousarray(col).view(np.int32)
        out.append(col)
    return out


class OutOfCoreLoader:
    """Streams random megabatches from a binary float32 row file.

    Worker threads prefetch into a ring of `n_buffers` buffers while the
    device computes, so disk latency overlaps with training. Rows are
    sampled with replacement from the first `train_rows` rows.

    `block_rows > 0` switches to block-then-row sampling: each megabatch is
    assembled from random CONTIGUOUS runs of `block_rows` rows, which makes
    the disk reads sequential on a file larger than RAM. It assumes a
    pre-shuffled file (rows within a run are file neighbours).
    """

    def __init__(self, path, n_rows, row_floats, batch_rows,
                 n_buffers=3, n_threads=2, seed=0, train_rows=0,
                 block_rows=0):
        self._h = None
        self._lib = _lib()
        self.batch_rows = int(batch_rows)
        self.row_floats = int(row_floats)
        need = int(n_rows) * int(row_floats) * 4
        try:
            actual = os.path.getsize(path)
        except OSError:
            raise IOError("dataset file %s does not exist" % path)
        if actual < need:
            raise IOError(
                "dataset file %s is %d bytes but n_rows=%d x row_floats=%d "
                "requires %d: a short mmap would SIGBUS on first touch"
                % (path, actual, n_rows, row_floats, need)
            )
        self._h = self._lib.hb_loader_open(
            str(path).encode(), int(n_rows), int(row_floats), int(batch_rows),
            int(n_buffers), int(n_threads), int(seed), int(train_rows),
            int(block_rows),
        )
        if not self._h:
            raise IOError("failed to open dataset %s" % path)

    def next(self):
        """Block until a prefetched megabatch is ready; return a host numpy
        COPY of it. The ring buffer goes back to the workers before this
        returns, so nothing downstream (a device copy included) ever reads
        memory a worker may be refilling. Raises RuntimeError if the loader
        is closed while waiting."""
        ptr = self._lib.hb_loader_next(self._h)
        if not ptr:
            raise RuntimeError("loader was closed while waiting for a batch")
        arr = np.ctypeslib.as_array(ptr, shape=(self.batch_rows, self.row_floats))
        out = np.array(arr)  # copy out of the ring buffer
        self._lib.hb_loader_release(self._h, ptr)
        return out

    def close(self):
        if self._h:
            self._lib.hb_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
