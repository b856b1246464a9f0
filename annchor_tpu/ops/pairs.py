"""Candidate-pair bookkeeping on padded tensors.

The reference tracks the ragged per-point pair lists in numba typed
Dicts (`get_IJs_from_check`, reference annchor/utils.py:494-540).  On
an accelerator raggedness is hostile, so the one core data structure here is a
*padded point-incidence matrix*:

    P_idx: int32 (nx, max_deg)  — indices into the flat pair array IJs,
                                  padded with m (a sentinel slot)
    P_cnt: int32 (nx,)          — true degree of each point

Every per-point operation (k-th-smallest thresholds, guarantee_nmin,
k-NN assembly) becomes a masked gather + top-k over this matrix —
fully vectorised, shardable over the point axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

F32_INF = np.float32(np.inf)


def build_point_index(IJs: np.ndarray, nx: int):
    """Build the padded incidence matrix from the (m, 2) pair array.

    Pairs are canonical (IJs[:, 0] < IJs[:, 1]); each pair id appears in
    the rows of both endpoints (reference I dict, utils.py:526-540).
    """
    IJs = np.asarray(IJs)
    m = IJs.shape[0]
    if (
        m == nx * (nx - 1) // 2
        and m
        and IJs[0, 0] == 0
        and IJs[0, 1] == 1
        and IJs[-1, 0] == nx - 2
    ):
        # complete candidate set in canonical row-major order: the
        # incidence matrix has a closed form — no sort needed
        from annchor_tpu.ops.device_pipeline import _pair_id_full

        return (
            _pair_id_full(nx),
            np.full(nx, nx - 1, dtype=np.int32),
        )
    I = IJs[:, 0].astype(np.int32, copy=False)
    J = IJs[:, 1].astype(np.int32, copy=False)
    cnt_i = np.bincount(I, minlength=nx).astype(np.int32)
    cnt_j = np.bincount(J, minlength=nx).astype(np.int32)
    counts = cnt_i + cnt_j
    max_deg = int(counts.max()) if m else 1
    P_idx = np.full((nx, max_deg), m, dtype=np.int32)
    ids = np.arange(m, dtype=np.int32)

    # slots [0, cnt_i[p]) hold p's pairs where p is the left endpoint,
    # the rest its right-endpoint pairs.  Candidate lists arrive sorted
    # by left endpoint (nonzero is row-major), so the left side needs
    # no sort at all; the right side needs one int32 counting argsort.
    start_i = np.zeros(nx, dtype=np.int64)
    np.cumsum(cnt_i[:-1], out=start_i[1:])
    if m and np.all(I[1:] >= I[:-1]):
        P_idx[I, ids - start_i[I]] = ids
    else:  # appended pair blocks (enemy graph) break the ordering
        oi = np.argsort(I, kind="stable")
        P_idx[I[oi], np.arange(m) - start_i[I[oi]]] = ids[oi]

    oj = np.argsort(J, kind="stable")
    start_j = np.zeros(nx, dtype=np.int64)
    np.cumsum(cnt_j[:-1], out=start_j[1:])
    Jo = J[oj]
    P_idx[Jo, np.arange(m) - start_j[Jo] + cnt_i[Jo]] = ids[oj]
    return P_idx, counts


def build_point_index_single(endpoints: np.ndarray, n: int):
    """Padded incidence matrix when each pair belongs to exactly one
    point (the query path: pairs are (database, query) and are indexed
    by their query endpoint only, reference query_functions.py:49-59).
    """
    endpoints = np.asarray(endpoints, dtype=np.int64)
    m = endpoints.shape[0]
    order = np.argsort(endpoints, kind="stable")
    counts = np.bincount(endpoints, minlength=n).astype(np.int32)
    max_deg = int(counts.max()) if m else 1
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    cols = np.arange(m, dtype=np.int64) - offsets[endpoints[order]]
    P_idx = np.full((n, max_deg), m, dtype=np.int32)
    P_idx[endpoints[order], cols] = order.astype(np.int32)
    return P_idx, counts


def point_gather(values, P_idx, pad_value):
    """Gather a per-pair array into the padded per-point layout.

    values: (m,) -> (nx, max_deg), with sentinel slots = pad_value.
    """
    values = jnp.asarray(values)
    padded = jnp.concatenate(
        [values, jnp.array([pad_value], dtype=values.dtype)]
    )
    return jnp.take(padded, jnp.asarray(P_idx), axis=0)


@functools.partial(jax.jit, static_argnames=("k",))
def _kth_smallest_jit(RA, P_idx, k: int):
    vals = point_gather(jnp.asarray(RA, jnp.float32), P_idx, F32_INF)
    neg_topk, _ = jax.lax.top_k(-vals, k + 1)
    return -neg_topk[:, k]


def _gather_np(values, P_idx, pad_value, dtype=np.float64):
    padded = np.append(np.asarray(values, dtype=dtype), dtype(pad_value))
    return padded[np.asarray(P_idx)]


def kth_smallest_per_point(RA, P_idx, k: int):
    """thresh[i] = (k+1)-th smallest RefineApprox among i's pairs
    (reference annchor.py:399-404 uses np.partition(..., nn)[nn]).

    Small problems run as plain numpy on the host — a device dispatch
    (or even single-core jax-CPU) is slower than the memcpy."""
    P_idx = np.asarray(P_idx)
    if P_idx.size < 64_000_000:
        vals = _gather_np(RA, P_idx, np.inf)
        kk = min(k, vals.shape[1] - 1)
        return np.partition(vals, kk, axis=1)[:, kk]
    return _kth_smallest_jit(np.asarray(RA), P_idx, k)


@jax.jit
def _guarantee_marks(RA, ncm, P_idx, P_cnt, n_todo):
    """Boolean per-pair marks for guarantee_nmin (see below)."""
    m = RA.shape[0]
    vals = point_gather(jnp.asarray(RA, jnp.float32), P_idx, F32_INF)
    ncm_pad = point_gather(jnp.asarray(ncm), P_idx, False)
    todo_vals = jnp.where(ncm_pad, vals, F32_INF)  # only uncomputed
    svals = jnp.sort(todo_vals, axis=1)
    # value of the n_todo-th smallest uncomputed (0-indexed), per point
    idx = jnp.clip(n_todo, 0, svals.shape[1] - 1)
    kth = jnp.take_along_axis(svals, idx[:, None], axis=1)[:, 0]
    mark_rows = (
        (todo_vals < kth[:, None]) & ncm_pad & (n_todo[:, None] > 0)
    )
    # scatter back to flat pair ids (duplicates fine: mark is idempotent)
    flat_ids = jnp.asarray(P_idx).reshape(-1)
    flat_marks = mark_rows.reshape(-1)
    marks = jnp.zeros(m + 1, dtype=bool)
    marks = marks.at[flat_ids].max(flat_marks)
    return marks[:m]


def guarantee_nmin(RA, ncm, P_idx, P_cnt, nmin: int):
    """Force at least nmin computed-or-forced pairs per point.

    Reference (utils.py:606-621): points with fewer than nmin computed
    pairs get their smallest uncomputed RefineApprox entries set to -1
    so the refinement step picks them.  The reference loops points
    sequentially (later points observe earlier -1 writes); this
    vectorised version marks in a single pass, which changes only the
    tie-ordering of forced pairs, not the accuracy contract.
    Returns updated RA (np.float64 copy).
    """
    RA = np.asarray(RA, dtype=np.float64)
    ncm = np.asarray(ncm)
    P_idx = np.asarray(P_idx)
    m = RA.shape[0]
    if P_idx.size < 64_000_000:  # host numpy path (see kth_smallest)
        ncm_pad = _gather_np(ncm, P_idx, False, dtype=bool)
        vals = _gather_np(RA, P_idx, np.inf)
        todo_vals = np.where(ncm_pad, vals, np.inf)
        n_computed = (~ncm_pad & (P_idx < m)).sum(axis=1)
        n_todo = np.clip(nmin - n_computed, 0, todo_vals.shape[1] - 1)
        svals = np.sort(todo_vals, axis=1)
        kth = np.take_along_axis(svals, n_todo[:, None], axis=1)
        mark_rows = (todo_vals < kth) & ncm_pad & (n_todo[:, None] > 0)
        marks = np.zeros(m + 1, dtype=bool)
        np.maximum.at(marks, P_idx.reshape(-1), mark_rows.reshape(-1))
        marks = marks[:m]
    else:
        n_computed = np.asarray(
            point_gather(jnp.asarray(~ncm), P_idx, False).sum(axis=1)
        )
        n_todo = jnp.asarray(
            np.maximum(nmin - n_computed, 0).astype(np.int32)
        )
        marks = np.asarray(
            _guarantee_marks(
                jnp.asarray(RA, jnp.float32), ncm, P_idx, P_cnt, n_todo
            )
        )
    out = RA.copy()
    out[marks] = -1.0
    return out


def empirical_cdf_probs(p, labels, errs_by_label):
    """prob[k] = empirical CDF of the residual distribution of pair k's
    bin, evaluated at margin p[k] (reference get_probs,
    utils.py:581-589).

    p: (m,) float; labels: (m,) int bin labels;
    errs_by_label: dict label -> sorted residual array.
    """
    p = np.asarray(p)
    labels = np.asarray(labels)
    prob = np.zeros(p.shape[0], dtype=np.float64)
    for label, errs in errs_by_label.items():
        mask = labels == label
        if mask.any() and len(errs):
            prob[mask] = np.searchsorted(errs, p[mask]) / len(errs)
    return prob


@functools.partial(jax.jit, static_argnames=("nn",))
def _knn_select(RA32, ncm, P_idx, nn: int, m: int):
    """Device selection of each point's nn best pair slots.

    Implements reference get_nn's penalty scheme (utils.py:383-429):
    uncomputed pairs get +max(row) so computed pairs win, but
    uncomputed ones can still fill trailing slots.
    """
    vals = point_gather(RA32, P_idx, F32_INF)
    ncm_pad = point_gather(ncm, P_idx, True)
    valid = P_idx < m
    mx = jnp.max(jnp.where(valid, vals, -F32_INF), axis=1, keepdims=True)
    d = jnp.where(valid, vals + jnp.where(ncm_pad, mx, 0.0), F32_INF)
    _, cols = jax.lax.top_k(-d, nn)
    return cols


def knn_from_pairs(RA, IJs, P_idx, ncm, nn: int):
    """k-NN graph assembly (reference get_nn, utils.py:383-429).

    Selection runs on device in float32; the reported distances are
    re-read from the float64 host RA so exact metric values keep full
    precision end-to-end.  Returns (ngi, ngd, pair_ids), each (nx, nn).
    """
    nx = P_idx.shape[0]
    m = IJs.shape[0]
    P_np = np.asarray(P_idx)
    if P_np.size < 64_000_000:  # host numpy path (see kth_smallest)
        vals = _gather_np(RA, P_np, np.inf)
        ncm_pad = _gather_np(ncm, P_np, True, dtype=bool)
        valid = P_np < m
        mx = np.max(np.where(valid, vals, -np.inf), axis=1, keepdims=True)
        d = np.where(valid, vals + np.where(ncm_pad, mx, 0.0), np.inf)
        if d.shape[1] < nn:  # fewer candidate slots than neighbours
            pad = np.full((d.shape[0], nn - d.shape[1]), np.inf)
            d = np.concatenate([d, pad], axis=1)
            P_np = np.concatenate(
                [P_np, np.full((d.shape[0], nn - P_np.shape[1]), m)],
                axis=1,
            )
        kk = min(nn - 1, d.shape[1] - 1)
        part = np.argpartition(d, kk, axis=1)[:, :nn]
        dd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(dd, axis=1, kind="stable")
        cols = np.take_along_axis(part, order, axis=1)
    else:
        cols = np.asarray(
            _knn_select(
                jnp.asarray(RA, jnp.float32),
                jnp.asarray(ncm),
                jnp.asarray(P_idx),
                nn,
                m,
            )
        )
    pair_ids = np.take_along_axis(P_np, cols, axis=1)
    pair_sum = np.concatenate([np.asarray(IJs).sum(axis=1), [0]]).astype(
        np.int64
    )
    ngi = pair_sum[pair_ids.astype(np.int64)] - np.arange(nx)[:, None]
    ngi = np.where(pair_ids < m, ngi, -1)
    RA64 = np.concatenate([np.asarray(RA, np.float64), [np.inf]])
    ngd = RA64[pair_ids]
    return ngi.astype(np.int64), ngd, pair_ids
