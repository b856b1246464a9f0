"""Exact k-NN ground truth at scale, without the O(n^2) matrix.

The reference's accuracy contract is ``compare_neighbor_graphs`` over
EVERY row against an exact graph (reference
annchor/tests/test_annchor.py:95-102), which its ``BruteForce``
supplies only up to a few thousand points (the full distance matrix
plus one C-extension call per pair).  Here exact graphs stay feasible
at 20k-100k points: blocked one-vs-all device columns end in a
``top_k`` inside the same program, so the host only ever sees
(block, k) results.  This is both the benchmark oracle and a
user-facing capability (an exact graph for slow metrics at scales the
reference cannot reach).
"""

from __future__ import annotations

import numpy as np

from annchor_tpu.metrics import (
    Metric,
    _DenseBatchEngine,
    _LevenshteinEngine,
    get_function_from_input,
)

__all__ = ["exact_knn", "exact_rows", "exact_query_rows"]


def _resolve(func, func_kwargs):
    if isinstance(func, Metric):
        return func
    return get_function_from_input(func, func_kwargs)


def _dense_knn(engine, X, k, rows, block, verbose):
    import jax
    import jax.numpy as jnp

    from annchor_tpu.progress import progress

    Xd = engine._data_dev(X)
    n = Xd.shape[0]
    kern = engine._raw_kernel()

    @jax.jit
    def block_topk(Xd, blk):
        S = blk.shape[0]
        I = jnp.repeat(blk, n)
        J = jnp.tile(jnp.arange(n, dtype=blk.dtype), S)
        d = kern(Xd, Xd, I, J).reshape(S, n)
        neg, idx = jax.lax.top_k(-d, k)
        return -neg, idx

    idx_out = np.empty((rows.shape[0], k), dtype=np.int64)
    dist_out = np.empty((rows.shape[0], k), dtype=np.float64)
    for s in progress(range(0, rows.shape[0], block), "exact rows", verbose):
        blk = rows[s : s + block]
        d, ix = block_topk(Xd, jnp.asarray(blk, jnp.int32))
        dist_out[s : s + blk.shape[0]] = np.asarray(d)
        idx_out[s : s + blk.shape[0]] = np.asarray(ix)
    return idx_out, dist_out


def _batch_eval(metric):
    if metric.batch is not None:
        return metric.batch
    return lambda X, Z, IJ: np.array(
        [metric.scalar(X[i], Z[j]) for i, j in IJ], dtype=np.float64
    )


def _blocked_rows(ev, X, Z, row_ids, n_cols, block, verbose):
    """Full distance rows through a batched evaluator, `block` rows
    per call: one call per row would pay a dataset upload and a
    blocking download per row (minutes of pure overhead at scale);
    one call per block pays them once per `block` rows."""
    from annchor_tpu.progress import progress

    row_ids = np.asarray(row_ids, dtype=np.int64)
    out = np.empty((row_ids.shape[0], n_cols), dtype=np.float64)
    cols = np.arange(n_cols, dtype=np.int64)
    for s in progress(
        range(0, row_ids.shape[0], block), "exact rows", verbose
    ):
        blk = row_ids[s : s + block]
        IJ = np.stack(
            [np.repeat(blk, n_cols), np.tile(cols, blk.shape[0])],
            axis=1,
        )
        out[s : s + blk.shape[0]] = np.asarray(
            ev(X, Z, IJ), dtype=np.float64
        ).reshape(blk.shape[0], n_cols)
    return out


def _host_knn(metric, X, k, rows, block, verbose):
    from annchor_tpu.progress import progress

    n = len(X)
    ev = _batch_eval(metric)
    idx_out = np.empty((rows.shape[0], k), dtype=np.int64)
    dist_out = np.empty((rows.shape[0], k), dtype=np.float64)
    for s in progress(
        range(0, rows.shape[0], block), "exact rows", verbose
    ):
        blk = rows[s : s + block]
        # (block, n) resident at a time — never O(n^2)
        D = _blocked_rows(ev, X, X, blk, n, block, False)
        part = np.argpartition(D, min(k - 1, n - 1), axis=1)[:, :k]
        d_part = np.take_along_axis(D, part, axis=1)
        order = np.argsort(d_part, axis=1, kind="stable")
        idx_out[s : s + blk.shape[0]] = np.take_along_axis(
            part, order, axis=1
        )
        dist_out[s : s + blk.shape[0]] = np.take_along_axis(
            d_part, order, axis=1
        )
    return idx_out, dist_out


def exact_knn(X, func, func_kwargs=None, k=16, rows=None, block=64,
              verbose=False):
    """Exact k-smallest neighbours per row (self included at d=0).

    Returns (indices int64 (R, k), distances float64 (R, k)) sorted
    ascending.  ``rows=None`` computes every row — a full exact k-NN
    graph directly comparable with ``Annchor.neighbor_graph`` via
    ``compare_neighbor_graphs`` (pass k = n_neighbors there).  Blocked
    one-vs-all device programs; nothing O(n^2) is ever resident.
    """
    metric = _resolve(func, func_kwargs)
    n = len(X)
    if rows is None:
        rows = np.arange(n, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    k = int(min(k, n))
    eng = metric.batch
    if isinstance(eng, _LevenshteinEngine):
        enc = eng._encode(X)[2]
        if enc is not None:
            from annchor_tpu.ops.levenshtein_myers import myers_knn

            return myers_knn(enc, k, rows=rows, block=block, verbose=verbose)
    if isinstance(eng, _DenseBatchEngine):
        return _dense_knn(eng, X, k, rows, block, verbose)
    return _host_knn(metric, X, k, rows, block, verbose)


def exact_rows(X, func, func_kwargs=None, rows=None, block=64,
               verbose=False):
    """Full exact distance rows (R, n) for the given row indices."""
    metric = _resolve(func, func_kwargs)
    n = len(X)
    if rows is None:
        rows = np.arange(n, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    eng = metric.batch
    if isinstance(eng, _LevenshteinEngine):
        enc = eng._encode(X)[2]
        if enc is not None:
            from annchor_tpu.ops.levenshtein_myers import myers_rows

            return myers_rows(enc, rows, block=block, verbose=verbose)
    return _blocked_rows(_batch_eval(metric), X, X, rows, n, block,
                         verbose)


def exact_query_rows(X, Q, func, func_kwargs=None, block=64, verbose=False):
    """Exact distance rows (nq, nx) from out-of-sample queries to X."""
    metric = _resolve(func, func_kwargs)
    nx, nq = len(X), len(Q)
    eng = metric.batch
    if isinstance(eng, _LevenshteinEngine):
        XQ = list(X) + list(Q)
        # transient encode: the X+Q list is throwaway — caching it
        # would evict the fitted dataset's encoding
        enc = eng._encode_transient(XQ)[2]
        if enc is not None:
            from annchor_tpu.ops.levenshtein_myers import myers_rows

            rows = np.arange(nx, nx + nq, dtype=np.int64)
            return myers_rows(enc, rows, block=block, n_keep=nx,
                              verbose=verbose)
    # engines take (X, Z, IJ) with IJ[:, 0] indexing the first arg
    return _blocked_rows(
        _batch_eval(metric), Q, X,
        np.arange(nq, dtype=np.int64), nx, block, verbose,
    )
