"""The port's out-of-core loader and streaming trainer
(henbun_tpu_torch/io/) on the CPU: the twin of tests/test_io.py without
its sharded-optimizer case (``parallel/`` is not ported), plus the row
files crossing between the two packages.

Tolerances: rows are compared byte for byte; the streamed linear fit to
atol 0.1 of its coefficients, as in tests/test_io.py.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import henbun_tpu_torch as thb
from henbun_tpu_torch import models as tmodels
from henbun_tpu_torch.io import loader as tio
from henbun_tpu_torch.io.streaming import optimize_streaming
from henbun_tpu_torch.ops import _build


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1000, 3)).astype(np.float32)
    Y = (X @ np.array([1.0, -2.0, 0.5], np.float32))[:, None] + 0.05 * rng.normal(
        size=(1000, 1)
    ).astype(np.float32)
    path = tmp_path_factory.mktemp("data") / "rows.f32"
    n, row_floats, slices, dtypes = tio.write_dataset(str(path), X, Y)
    return str(path), n, row_floats, slices, X, Y


class LinReg(thb.Model):
    def setUp(self):
        self.x = thb.MinibatchData(np.zeros((8, 3), np.float32))
        self.y = thb.MinibatchData(np.zeros((8, 1), np.float32))
        self.w = thb.Variable([3, 1], stddev=0.1)

    @thb.AutoOptimize()
    def obj(self):
        return -torch.sum(torch.square(self.y - torch.matmul(self.x, self.w)))


def test_library_builds_into_the_build_directory():
    tio._lib()
    path = tio.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(tio.SOURCE)))


def test_rows_come_from_dataset(dataset):
    path, n, row_floats, slices, X, Y = dataset
    rows = np.concatenate([X, Y], axis=1)
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=64, seed=1) as dl:
        batch = dl.next()
    assert batch.shape == (64, 4)
    row_set = {r.tobytes() for r in rows}
    assert all(r.tobytes() in row_set for r in batch)


def test_train_rows_restriction(dataset):
    path, n, row_floats, slices, X, Y = dataset
    rows = np.concatenate([X, Y], axis=1)
    train_set = {r.tobytes() for r in rows[:100]}
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=256, seed=2,
                             train_rows=100) as dl:
        assert all(r.tobytes() in train_set for r in dl.next())


def test_block_sampling_contiguous_runs(dataset):
    path, n, row_floats, slices, X, Y = dataset
    rows = np.concatenate([X, Y], axis=1)
    row_index = {r.tobytes(): i for i, r in enumerate(rows)}
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=96, seed=5,
                             block_rows=32) as dl:
        idx = np.array([row_index[r.tobytes()] for r in dl.next()])
    for g in range(0, 96, 32):
        run = idx[g : g + 32]
        assert np.array_equal(run, np.arange(run[0], run[0] + 32))
    assert len({int(idx[g]) for g in range(0, 96, 32)}) > 1


def test_block_sampling_respects_train_split(dataset):
    path, n, row_floats, slices, X, Y = dataset
    rows = np.concatenate([X, Y], axis=1)
    train_set = {r.tobytes() for r in rows[:200]}
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=256, seed=6,
                             train_rows=200, block_rows=64) as dl:
        assert all(r.tobytes() in train_set for r in dl.next())


def test_block_sampling_ragged_tail_and_oversized_block(dataset):
    path, n, row_floats, slices, X, Y = dataset
    rows = np.concatenate([X, Y], axis=1)
    row_set = {r.tobytes() for r in rows}
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=50, seed=7,
                             train_rows=40, block_rows=1000) as dl:
        batch = dl.next()
    assert batch.shape == (50, 4)
    assert all(r.tobytes() in row_set for r in batch)


def test_successive_batches_differ(dataset):
    path, n, row_floats, slices, X, Y = dataset
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=128, n_buffers=3,
                             n_threads=2, seed=3) as dl:
        b1, b2, b3 = dl.next(), dl.next(), dl.next()
    assert not np.array_equal(b1, b2)
    assert not np.array_equal(b2, b3)


def test_next_returns_a_copy_the_workers_do_not_touch(dataset):
    """The buffer handed back is the caller's: later prefetches (which
    refill the ring buffer it came from) leave it as it was."""
    path, n, row_floats, slices, X, Y = dataset
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=128, n_buffers=2,
                             n_threads=2, seed=9) as dl:
        first = dl.next()
        kept = first.copy()
        for _ in range(6):
            dl.next()
    assert np.array_equal(first, kept)


def test_short_file_refused(tmp_path):
    path = str(tmp_path / "short.bin")
    np.zeros((10, 4), np.float32).tofile(path)
    with pytest.raises(IOError, match="SIGBUS|bytes"):
        tio.OutOfCoreLoader(path, n_rows=100, row_floats=4, batch_rows=8)
    with pytest.raises(IOError):
        tio.OutOfCoreLoader(str(tmp_path / "nope.bin"), 10, 4, 8)


def test_close_while_waiting_unblocks(tmp_path):
    """next() racing close() raises instead of deadlocking: hold every
    buffer so the consumer blocks, then close from another thread."""
    path = str(tmp_path / "d.bin")
    np.arange(64 * 4, dtype=np.float32).reshape(64, 4).tofile(path)
    ld = tio.OutOfCoreLoader(path, n_rows=64, row_floats=4, batch_rows=8,
                             n_buffers=2, n_threads=1)
    held = [ld._lib.hb_loader_next(ld._h) for _ in range(2)]
    assert all(bool(p) for p in held)
    t = threading.Timer(0.3, ld.close)
    t.start()
    t0 = time.time()
    with pytest.raises(RuntimeError, match="closed"):
        ld.next()
    assert time.time() - t0 < 10.0
    t.join()


def test_int_columns_roundtrip_exactly(tmp_path):
    path = str(tmp_path / "mixed.bin")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 3)).astype(np.float32)
    labels = rng.integers(-(2**30), 2**30, size=(256, 1), dtype=np.int64)
    n, row_floats, slices, dtypes = tio.write_dataset(path, X, labels)
    assert row_floats == 4 and dtypes[1] == np.dtype(np.int32)
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=32, n_threads=1,
                             seed=1) as ld:
        batch = ld.next()
    xs, ys = tio.read_columns(batch, slices, dtypes)
    assert ys.dtype == np.int32
    table = {tuple(r): int(v) for r, v in zip(np.round(X, 5), labels[:, 0])}
    for r, v in zip(np.round(xs, 5), ys[:, 0]):
        assert table[tuple(r)] == int(v)


def test_streaming_training(dataset):
    """C++ prefetch -> megabatch swap -> chunked training recovers the
    linear coefficients (two megabatches at scan_chunk 1,000)."""
    path, n, row_floats, slices, X, Y = dataset
    m = LinReg(seed=0, device="cpu")
    opt = m.obj().compile(thb.adam(0.05))
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=512, seed=4) as dl:
        optimize_streaming(opt, dl, slices, maxiter=1500, minibatch_size=64)
    assert np.allclose(m.w.value[:, 0], [1.0, -2.0, 0.5], atol=0.1)


def test_streaming_amortized(tmp_path):
    """Megabatches into the amortized model: C++ prefetch -> feed-slab
    encoder -> local q -> training."""
    thb.set_seed(0)
    X, Y = tmodels.make_synthetic_regression(n=4096, d_x=3)
    path = str(tmp_path / "amortized_rows.f32")
    n, row_floats, slices, dtypes = tio.write_dataset(path, X, Y)
    m = tmodels.AmortizedRegression(seed=0, X=X[:128], Y=Y[:128], d_z=2, hidden=8,
                                    device="cpu")
    m.n_data = n  # scale to the true dataset size, not the seed slice
    opt = m.ELBO().compile(thb.adam(0.005))
    cfg = thb.settings.get_settings()
    cfg.cuda.scan_chunk = 200
    with thb.settings.temp_settings(cfg), \
            tio.OutOfCoreLoader(path, n, row_floats, batch_rows=1024, seed=3) as dl:
        optimize_streaming(opt, dl, slices, maxiter=600, minibatch_size=64)
    objs = np.concatenate(opt.history) / n
    assert len(opt.history) == 3  # one chunk per megabatch
    assert np.isfinite(objs).all()
    assert np.mean(objs[-100:]) > np.mean(objs[:100])


def test_streaming_trains_on_every_row(dataset):
    """optimize_streaming defaults test_frac to 0: every megabatch row is
    in the train split, and test_index fails usefully."""
    path, n, row_floats, slices, X, Y = dataset
    m = LinReg(seed=0, device="cpu")
    opt = m.obj().compile(thb.adam(0.05))
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=512, seed=7) as dl:
        optimize_streaming(opt, dl, slices, maxiter=10, minibatch_size=64)
    assert m._index.train_size == 512
    assert m._index.test_size == 0
    with pytest.raises(ValueError, match="test_frac"):
        m._index.test_index(16)
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=512, seed=8) as dl:
        optimize_streaming(opt, dl, slices, maxiter=10, minibatch_size=64, test_frac=0.1)
    assert m._index.test_size == 51


def test_streaming_refuses_a_wrong_slice_count(dataset):
    path, n, row_floats, slices, X, Y = dataset
    opt = LinReg(seed=0, device="cpu").obj().compile()
    with tio.OutOfCoreLoader(path, n, row_floats, batch_rows=64, seed=1) as dl:
        with pytest.raises(ValueError, match="column_slices"):
            optimize_streaming(opt, dl, slices[:1], maxiter=1, minibatch_size=8)


def test_row_files_cross_between_the_packages(tmp_path, monkeypatch):
    """A file written by either package's write_dataset is byte for byte
    the other's, and each package's loader reads the other's rows. The
    JAX package's library is built from its source into tmp_path, so this
    test never writes next to that source while tests/test_io.py (another
    worker) may be building it there."""
    from henbun_tpu.io import loader as jio

    monkeypatch.setattr(jio, "_SO_PATH", str(tmp_path / "_dataloader.so"))
    monkeypatch.setattr(jio, "_LIB", None)

    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 2)).astype(np.float32)
    labels = rng.integers(0, 7, size=(300, 1))
    j_path, t_path = str(tmp_path / "jax.bin"), str(tmp_path / "torch.bin")
    j_meta = jio.write_dataset(j_path, X, labels)
    t_meta = tio.write_dataset(t_path, X, labels)
    assert j_meta[:3] == t_meta[:3] and list(j_meta[3]) == list(t_meta[3])
    with open(j_path, "rb") as a, open(t_path, "rb") as b:
        assert a.read() == b.read()
    n, row_floats, slices, dtypes = t_meta
    rows = np.fromfile(j_path, np.float32).reshape(n, row_floats)
    row_set = {r.tobytes() for r in rows}
    with tio.OutOfCoreLoader(j_path, n, row_floats, batch_rows=64, seed=2) as dl:
        assert all(r.tobytes() in row_set for r in dl.next())
    with jio.OutOfCoreLoader(t_path, n, row_floats, batch_rows=64, seed=2) as dl:
        batch = dl.next()
    assert all(r.tobytes() in row_set for r in batch)
    # and the same seed draws the same rows (one source, one generator)
    with tio.OutOfCoreLoader(t_path, n, row_floats, batch_rows=64, seed=2,
                             n_threads=1) as a, \
            jio.OutOfCoreLoader(j_path, n, row_floats, batch_rows=64, seed=2,
                                n_threads=1) as b:
        assert np.array_equal(a.next(), b.next())
    xs, ys = tio.read_columns(batch, slices, dtypes)
    jx, jy = jio.read_columns(batch, slices, dtypes)
    assert np.array_equal(xs, jx) and np.array_equal(ys, jy) and ys.dtype == np.int32
