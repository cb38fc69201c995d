"""Streaming training over out-of-core data.

Bridges :class:`~henbun_tpu_torch.io.loader.OutOfCoreLoader` megabatches
into the chunked training loop: each chunk of ``[cuda] scan_chunk`` steps
trains against one prefetched megabatch (minibatches drawn on the device
from within it), while the C++ workers prefetch the next one from disk.

Buffer handling: ``loader.next()`` hands back a host copy and returns its
ring buffer to the workers at once. The megabatch becomes the model's
``MinibatchData`` arrays and reaches the device through their
``device_value`` copy, a synchronous copy from pageable host memory, when
the chunk gathers its data. So the device never reads a buffer a worker
may be refilling, and the host array may be dropped as soon as the chunk
has started.
"""
from __future__ import annotations

from .._settings import settings
from ..core.param import MinibatchData, graph_key


def optimize_streaming(optimizer, loader, column_slices, maxiter, minibatch_size,
                       test_frac=0.0):
    """Run `maxiter` steps of `optimizer` streaming data from `loader`.

    - optimizer: an Optimizer whose model has MinibatchData nodes
      (name-sorted order must match `column_slices`).
    - loader: an OutOfCoreLoader yielding [megabatch_rows, row_floats].
    - column_slices: [(lo, hi), ...] column ranges of each MinibatchData
      node within a row, in the model's name-sorted MinibatchData order (as
      returned by `write_dataset`). Columns of the row that no slice names
      are not read.
    - test_frac: held-out fraction of each megabatch, DEFAULT 0: unlike the
      in-core Indexer default (0.1), streaming holds nothing out, since a
      split would discard that share of every megabatch read from disk
      without ever evaluating on it. Set > 0 only if you evaluate per
      megabatch yourself.
    """
    model = optimizer.model
    optimizer._require_compiled()
    model._index.test_frac = float(test_frac)
    mb_nodes = [
        v for v in model.get_variables(graph_key.DATA) if isinstance(v, MinibatchData)
    ]
    if len(mb_nodes) != len(column_slices):
        raise ValueError(
            "column_slices has %d entries for %d MinibatchData nodes"
            % (len(column_slices), len(mb_nodes))
        )

    chunk = int(settings.cuda.scan_chunk)
    done = 0
    while done < maxiter:
        mega = loader.next()
        for node, (lo, hi) in zip(mb_nodes, column_slices):
            node.data = mega[:, lo:hi].reshape((mega.shape[0],) + tuple(node.shape))
        model._index.setUp(mega.shape[0])
        n = min(chunk, maxiter - done)
        optimizer.optimize(maxiter=n, minibatch_size=minibatch_size)
        done += n
    return optimizer
