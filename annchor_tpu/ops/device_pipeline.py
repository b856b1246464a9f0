"""Device-resident fit pipeline.

The orchestration of a fit stays a staged host loop (the control flow —
sampler warnings, early exit, plug-ins — is inherently dynamic), but on
the accelerator the cost model is dominated by *bytes moved* and host
synchronisation, not dispatches.  This module keeps the entire per-pair state on device as float32

    lb, ub, dad, RA : (m,) f32      IJ_i, IJ_j : (m,) i32
    ncm             : (m,) bool     P_idx      : (nx, max_deg) i32

and reduces the per-iteration host-device traffic to kilobytes: sampled
feature rows come down, regression coefficients and exact distances go
up, and the refinement selection returns only the chosen pair ids.
Full-size arrays cross the link exactly twice per fit (the dad column
for the host sampler, and nothing else until a user asks for
``ann.features`` — materialised lazily).

Bound tightening becomes a *tropical (min-plus / max-abs-diff) matrix
product* of the computed-distance matrix with itself — one dispatch,
zero transfers — instead of the reference's per-pair host
intersections (reference annchor/annchor.py:475-512, utils.py:304-352).

Numeric semantics mirror the host pipeline stage for stage (same
stratified sampler on the host, same closed-form regression, same
empirical-CDF selection rule, reference annchor/annchor.py:395-473);
equivalence is pinned by the accuracy-budget tests.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

F32_INF = np.float32(np.inf)

# full-matrix tropical tighten is O(nx^2) memory; beyond this the
# chunked per-pair kernel (ops.bounds_update) is the right tool
MAX_FULL_MATRIX_NX = 4096


# ---------------------------------------------------------------------------
# jitted programs (pure functions of device arrays)


def _features_body(D32, ij_i, ij_j, chunk: int):
    """Chunked LB/UB/dad loop body (shared by the single-chip jit and
    the per-chip shard_map program in ops/sharded_fit.py)."""
    na = D32.shape[1]
    m = ij_i.shape[0]
    # never pad a small batch (or shard) up to the full chunk size
    chunk = min(chunk, max(m, 1))
    cA = jnp.argmin(D32, axis=1).astype(jnp.int32)
    Dflat = D32.reshape(-1)

    nchunks = (m + chunk - 1) // chunk
    padm = nchunks * chunk
    gi_all = jnp.pad(ij_i, (0, padm - m))
    gj_all = jnp.pad(ij_j, (0, padm - m))

    def body(t, state):
        lb, ub, dad = state
        gi = jax.lax.dynamic_slice(gi_all, (t * chunk,), (chunk,))
        gj = jax.lax.dynamic_slice(gj_all, (t * chunk,), (chunk,))
        Di = jnp.take(D32, gi, axis=0)
        Dj = jnp.take(D32, gj, axis=0)
        lb_c = jnp.max(jnp.abs(Di - Dj), axis=1)
        ub_c = jnp.min(Di + Dj, axis=1)
        dad_c = (
            jnp.take(Dflat, gi * na + jnp.take(cA, gj))
            + jnp.take(Dflat, gj * na + jnp.take(cA, gi))
        ) * 0.5
        lb = jax.lax.dynamic_update_slice(lb, lb_c, (t * chunk,))
        ub = jax.lax.dynamic_update_slice(ub, ub_c, (t * chunk,))
        dad = jax.lax.dynamic_update_slice(dad, dad_c, (t * chunk,))
        return lb, ub, dad

    z = jnp.zeros(padm, dtype=jnp.float32)
    lb, ub, dad = jax.lax.fori_loop(0, nchunks, body, (z, z, z))
    return lb[:m], ub[:m], dad[:m]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _features_init(D32, ij_i, ij_j, chunk: int = 1 << 21):
    """LB/UB/dad for every pair (device-resident output), chunked
    inside the program: the (m, na) gather intermediates would need
    ~20 GB at 10^8 pairs.  The double-anchor lookups are flat 1-d
    gathers — an (m, 1) take_along_axis intermediate would get the
    (8, 128) tile layout and balloon to ~1 KB per pair."""
    return _features_body(D32, ij_i, ij_j, chunk)


@functools.partial(jax.jit, static_argnames=("is_metric", "init"))
def _regress_update(
    lb, ub, dad, RA, ncm, inner_edges, coefs, icepts,
    sample_ids, sample_y, is_metric: bool, init: bool,
):
    """Predict every pair from the fitted per-bin linear model, clip to
    bounds (metric spaces), overwrite the fresh sample rows with their
    exact values.  Returns (RA', ncm').  The *sample* predictions (for
    the residual model) are replicated on host from the already-
    downloaded sample rows (`predict_sample_host`) so this dispatch
    never blocks — per-iteration host round trips, not FLOPs, are the
    cost model.

    Bin convention matches the host regressor: (lo, hi] via
    side='left' on the interior edges."""
    labels = jnp.searchsorted(inner_edges, dad, side="left")
    # per-bin coefficients via a K-way select chain: K full predictions
    # instead of a per-element gather
    K = coefs.shape[0]
    pred = jnp.zeros_like(dad)
    for b in range(K):
        pred_b = (
            lb * coefs[b, 0]
            + ub * coefs[b, 1]
            + dad * coefs[b, 2]
            + icepts[b]
        )
        pred = jnp.where(labels == b, pred_b, pred)
    if is_metric:
        pred = jnp.clip(pred, lb, ub)
    ncm2 = ncm.at[sample_ids].set(False)
    if init:
        RA2 = pred
    else:
        RA2 = jnp.where(ncm2, pred, RA)
    RA2 = RA2.at[sample_ids].set(sample_y)
    return RA2, ncm2


def predict_sample_host(regression, sample_features):
    """The unclipped per-bin linear prediction at the sample rows,
    replicated on host in float32 (same expression tree and bin
    convention as `_regress_update`'s device program).  The inputs are
    exact: sample feature rows come down the link as the device's own
    f32 values.  Avoids blocking on the regress dispatch just to read
    back n_samples floats."""
    c = np.asarray(regression.coefs, np.float32)
    ic = np.asarray(regression.intercepts, np.float32)
    inner = np.asarray(regression.sample_bins[1:-1], np.float32)
    lb = sample_features[:, 0].astype(np.float32)
    ub = sample_features[:, 1].astype(np.float32)
    dad = sample_features[:, 2].astype(np.float32)
    labels = np.searchsorted(inner, dad, side="left")
    pred = (
        lb * c[labels, 0]
        + ub * c[labels, 1]
        + dad * c[labels, 2]
        + ic[labels]
    )
    return pred.astype(np.float64)


def _sample_draw_body(dad, ncm, key, ilo, ihi, pool_n, quotas: tuple,
                      equal_mass: bool = False):
    """Stratified without-replacement sample drawn on device.

    Numerically mirrors the host SimpleStratifiedSampler: bin edges are
    a linspace between the pool's ilo-th/ihi-th order statistics of the
    stratification feature; each bin contributes quotas[b] uniform
    draws.  One masked sort + one random-key argsort replace the host's
    download of the full feature column.  Returns (ids (sum(quotas),),
    got (K,), inner edges) where slots past a bin's availability are -1.

    equal_mass=True uses pool-quantile edges instead — the retry for
    strongly multimodal features, where linspace edges land in density
    gaps and leave bins empty (e.g. in- vs cross-cluster distances)."""
    n_bins = len(quotas)
    pool_vals = jnp.where(ncm, dad, F32_INF)
    svals = jnp.sort(pool_vals)
    if equal_mass:
        qix = (jnp.arange(1, n_bins, dtype=jnp.int32) * pool_n) // n_bins
        inner = jnp.take(svals, qix)
    else:
        lo = svals[ilo]
        hi = svals[ihi]
        # linspace(lo, hi, n_bins-1) interior edges, +-inf outside
        inner = lo + (hi - lo) * jnp.arange(n_bins - 1) / jnp.float32(
            max(n_bins - 2, 1)
        )
    labels = jnp.searchsorted(inner, dad, side="right")

    # group pool by bin with random order inside each bin: labels are
    # < n_bins and the random key is < 1, so label + key sorts
    # lexicographically
    r = jax.random.uniform(key, dad.shape, dtype=jnp.float32)
    sort_key = jnp.where(
        ncm, labels.astype(jnp.float32) + r * 0.999, F32_INF
    )
    order = jnp.argsort(sort_key)

    counts = jnp.zeros(n_bins, dtype=jnp.int32)
    pool_labels = jnp.where(ncm, labels, n_bins)
    counts = counts.at[pool_labels].add(1, mode="drop")
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    # sentinel tail so an under-full final bin never wraps the slice
    order = jnp.concatenate(
        [order, jnp.full((max(quotas),), -1, order.dtype)]
    )

    picks, got = [], []
    for b in range(n_bins):
        q = quotas[b]
        ids_b = jax.lax.dynamic_slice(order, (starts[b],), (q,))
        take_b = jnp.minimum(counts[b], q)
        valid = (jnp.arange(q) < take_b) & (ids_b >= 0)
        picks.append(jnp.where(valid, ids_b, -1))
        got.append(take_b)
    return jnp.concatenate(picks), jnp.stack(got), inner


_sample_draw = functools.partial(jax.jit, static_argnames=(
    "quotas", "equal_mass"))(_sample_draw_body)


def _pair_id_full(nx: int):
    """Analytic padded incidence matrix for the all-pairs candidate set
    (loc_thresh=1 frequently keeps every pair at small nx): pair (a, b),
    a < b, lives at id a*nx - a(a+1)/2 + (b - a - 1)."""
    i = np.arange(nx, dtype=np.int64)[:, None]
    s = np.arange(nx - 1, dtype=np.int64)[None, :]
    partner = s + (s >= i)
    a = np.minimum(i, partner)
    b = np.maximum(i, partner)
    ids = a * nx - a * (a + 1) // 2 + (b - a - 1)
    return ids.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("nx",))
def _pidx_full_dev(nx: int):
    """Device twin of _pair_id_full — saves the (nx, nx-1) upload.
    int32 math holds to nx = 2^16 (pair ids < 2^31)."""
    i = jnp.arange(nx, dtype=jnp.int32)[:, None]
    s = jnp.arange(nx - 1, dtype=jnp.int32)[None, :]
    partner = s + (s >= i)
    a = jnp.minimum(i, partner)
    b = jnp.maximum(i, partner)
    return a * nx - a * (a + 1) // 2 + (b - a - 1)


def _pidx_from_pairs_body(ij_i, ij_j, nx: int, max_deg: int):
    """Padded incidence matrix built on device: one argsort-based
    counting sort over the endpoint list (uploading a prebuilt host
    matrix costs hundreds of MB of host-device transfer at scale)."""
    m = ij_i.shape[0]
    endpoints = jnp.concatenate([ij_i, ij_j])
    pair_ids = jnp.tile(jnp.arange(m, dtype=jnp.int32), 2)
    order = jnp.argsort(endpoints, stable=True)
    se = jnp.take(endpoints, order)
    counts = jnp.zeros(nx, dtype=jnp.int32).at[endpoints].add(1, mode="drop")
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    cols = jnp.arange(2 * m, dtype=jnp.int32) - jnp.take(starts, se)
    P = jnp.full((nx, max_deg), m, dtype=jnp.int32)
    return P.at[se, cols].set(jnp.take(pair_ids, order), mode="drop")


_pidx_from_pairs = functools.partial(jax.jit, static_argnames=(
    "nx", "max_deg"))(_pidx_from_pairs_body)


def _pidx_from_pairs_capped_body(ij_i, ij_j, lb, nx: int, max_deg: int):
    """Degree-capped incidence matrix: each point lists at most
    max_deg candidate pairs, kept in ascending lower-bound order so a
    truncated hub row retains its most promising candidates.  Every
    pair still exists in the flat pair state (bounds, regression,
    selection by probability, tightening all see it); truncation only
    affects the per-point threshold / guarantee / graph-assembly
    passes, and a dropped entry usually survives in its partner's
    row.  Needed because hub degrees at large nx would otherwise put
    the (nx, max_deg) matrix at > 4 GB resident."""
    m = ij_i.shape[0]
    endpoints = jnp.concatenate([ij_i, ij_j])
    pair_ids = jnp.tile(jnp.arange(m, dtype=jnp.int32), 2)
    lb2 = jnp.tile(lb, 2)
    o1 = jnp.argsort(lb2, stable=True)
    o2 = jnp.argsort(jnp.take(endpoints, o1), stable=True)
    order = jnp.take(o1, o2)  # grouped by endpoint, lb-ascending within
    se = jnp.take(endpoints, order)
    counts = jnp.zeros(nx, dtype=jnp.int32).at[endpoints].add(1, mode="drop")
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    cols = jnp.arange(2 * m, dtype=jnp.int32) - jnp.take(starts, se)
    P = jnp.full((nx, max_deg), m, dtype=jnp.int32)
    return P.at[se, cols].set(jnp.take(pair_ids, order), mode="drop")


_pidx_from_pairs_capped = functools.partial(jax.jit, static_argnames=(
    "nx", "max_deg"))(_pidx_from_pairs_capped_body)


# resident (nx, max_deg) incidence budget: 2 GB of int32
PIDX_BUDGET_ELEMS = 1 << 29


def _tighten_cols(
    ij_i, ij_j, RA, ncm, lb, ub, thresh,
    ncol: int, cmax: int, chunk: int = 65536, P_idx=None,
    col_chunk: int | None = None,
):
    """Column-subsampled bound tightening for large nx.

    The full tropical self-product needs an (nx, nx) matrix; beyond
    MAX_FULL_MATRIX_NX the pseudo-anchors are restricted to the `ncol`
    highest-computed-degree points (any column subset yields valid
    bounds), and the per-pair update runs over at most `cmax`
    *contender* pairs (uncomputed, lower bound under the endpoint
    threshold cap) in in-program chunks.

    The (nx, ncol) panel scales with nx — 4.1 GB at nx=500k, a
    runtime HBM OOM alongside the resident pair state (measured) — so
    columns are processed in `col_chunk`-sized passes bounding the
    panel to ~1 GB; lb/ub thread through the passes with max/min
    updates, which makes the chunked result bit-identical to the
    whole-panel program (same candidate value set, max/min are
    order-free).  At nx <= ~130k the bound admits all 2048 columns
    and the loop is a single pass, i.e. exactly the old program.

    Scatters are slow per element, so the panel build avoids per-pair scatters when it can: with an UNCAPPED
    incidence matrix `P_idx`, the column points' incidence rows
    enumerate exactly the pairs that land in the panel (ncol*max_deg
    updates ~= 3.5M instead of 2*m ~= 94M; measured 0.14 s vs 2.40 s
    at the 100k/47M shape).  A degree-capped P_idx drops hub pairs, so
    callers must pass P_idx=None then (the pair-scatter build; that
    path re-scans the m pairs once per column pass).  The validity
    mask is folded into the panel as +inf entries, halving the
    contender-chunk gather traffic, and contender extraction is a
    cumsum + monotone scatter-max rather than flatnonzero."""
    nx = thresh.shape[0]
    m = RA.shape[0]
    if col_chunk is None:
        col_chunk = max(256, (1 << 28) // max(nx, 1))
    col_chunk = min(ncol, col_chunk)
    # pad the column list with repeats of the top column so every pass
    # has the same compiled shape (duplicate columns redo identical
    # max/min updates — harmless)
    ncol_pad = ((ncol + col_chunk - 1) // col_chunk) * col_chunk

    cols_ids, ids = _tighten_cols_prep(
        ij_i, ij_j, ncm, lb, thresh,
        ncol=ncol, ncol_pad=ncol_pad, cmax=cmax,
    )
    for c0 in range(0, ncol_pad, col_chunk):
        cols_c = jax.lax.dynamic_slice(cols_ids, (c0,), (col_chunk,))
        lb, ub = _tighten_cols_part(
            ij_i, ij_j, RA, ncm, lb, ub, ids, cols_c,
            nx=nx, chunk=chunk, n_real=min(col_chunk, ncol - c0),
            P_idx=P_idx,
        )
    return lb, ub


@functools.partial(jax.jit, static_argnames=("ncol", "ncol_pad", "cmax"))
def _tighten_cols_prep(
    ij_i, ij_j, ncm, lb, thresh, ncol: int, ncol_pad: int, cmax: int
):
    """One-shot prep for the column passes: the pseudo-anchor column
    list (top computed-degree points, padded to the pass multiple with
    repeats) and the contender pair ids (padded with m = sentinel:
    positions are the running count of contenders, so the scatter
    indices are sorted and duplicates max-reduce away)."""
    nx = thresh.shape[0]
    m = ncm.shape[0]
    w = (~ncm).astype(jnp.int32)
    deg = jnp.zeros(nx, dtype=jnp.int32)
    deg = deg.at[ij_i].add(w, mode="drop")
    deg = deg.at[ij_j].add(w, mode="drop")
    _, cols_ids = jax.lax.top_k(deg, ncol)
    if ncol_pad > ncol:
        cols_ids = jnp.concatenate([
            cols_ids,
            jnp.broadcast_to(cols_ids[:1], (ncol_pad - ncol,)),
        ])

    cap = jnp.maximum(jnp.take(thresh, ij_i), jnp.take(thresh, ij_j))
    cont = ncm & (lb < cap)
    pos = jnp.cumsum(cont.astype(jnp.int32)) - 1
    src = jnp.where(cont, jnp.arange(m, dtype=jnp.int32), -1)
    ids = jnp.full(cmax, -1, jnp.int32).at[pos].max(
        src, mode="drop", indices_are_sorted=True
    )
    return cols_ids, jnp.where(ids >= 0, ids, m)


@functools.partial(
    jax.jit, static_argnames=("nx", "chunk", "n_real")
)
def _tighten_cols_part(
    ij_i, ij_j, RA, ncm, lb, ub, ids, cols_ids, nx: int, chunk: int,
    n_real: int, P_idx=None,
):
    """One column pass: build the (nx, col_chunk) panel E for the
    given column subset and fold its bound updates into lb/ub over
    the precomputed contender ids.  Columns past `n_real` are the
    shape-padding repeats — their panel entries are masked out so the
    incidence-path scatter keeps unique target slots."""
    m = RA.shape[0]
    ncol = cols_ids.shape[0]
    cmax = ids.shape[0]

    # E (nx, ncol): computed distances into the column subset;
    # entries that are absent (uncomputed pair, or endpoint not a
    # column) read +inf
    if P_idx is None:
        # only the n_real real columns enter the point->slot map; pad
        # slots stay +inf in E (inert under the max/min updates)
        col_of = jnp.full(nx, -1, dtype=jnp.int32).at[
            cols_ids[:n_real]
        ].set(jnp.arange(n_real, dtype=jnp.int32))
        # entries that must not land are routed to column index ncol,
        # which mode="drop" discards (writing masked values instead
        # would clobber real entries)
        okv = ~ncm
        ci = jnp.take(col_of, ij_i)
        cj = jnp.take(col_of, ij_j)
        ci = jnp.where(okv & (ci >= 0), ci, ncol)
        cj = jnp.where(okv & (cj >= 0), cj, ncol)
        E = jnp.full((nx, ncol), F32_INF, dtype=jnp.float32)
        E = E.at[ij_j, ci].set(RA, mode="drop")
        E = E.at[ij_i, cj].set(RA, mode="drop")
    else:
        # incidence-row build: P_idx[c] lists every tracked pair at
        # column point c (pad sentinel = m); the partner endpoint is
        # (i + j) - c.  Tracked pairs are unique and the slot index is
        # part of the scatter key, so target slots stay unique even
        # across duplicate pad columns (each copy owns its slot, and
        # its duplicate values just re-enter the max/min); masked
        # entries are routed out of bounds and dropped.
        RA_pad = jnp.concatenate([RA, jnp.zeros(1, RA.dtype)])
        ncm_pad = jnp.concatenate([ncm, jnp.ones(1, dtype=bool)])
        ps_pad = jnp.concatenate(
            [(ij_i + ij_j).astype(jnp.int32), jnp.zeros(1, jnp.int32)]
        )
        rows = jnp.take(P_idx, cols_ids, axis=0)  # (ncol, max_deg)
        good = (rows < m) & ~jnp.take(ncm_pad, rows)
        val = jnp.take(RA_pad, rows)
        partner = jnp.take(ps_pad, rows) - cols_ids[:, None]
        d_pos = jnp.arange(rows.shape[1], dtype=jnp.int32)[None, :]
        row_idx = jnp.where(good, partner, nx + d_pos)
        c_idx = jnp.broadcast_to(
            jnp.arange(ncol, dtype=jnp.int32)[:, None], rows.shape
        )
        E = jnp.full((nx, ncol), F32_INF, jnp.float32).at[
            row_idx, c_idx
        ].set(
            jnp.where(good, val, 0.0), mode="drop", unique_indices=True
        )

    ij_i_pad = jnp.concatenate([ij_i, jnp.zeros(1, ij_i.dtype)])
    ij_j_pad = jnp.concatenate([ij_j, jnp.zeros(1, ij_j.dtype)])
    lb_pad = jnp.concatenate([lb, jnp.zeros(1, lb.dtype)])
    ub_pad = jnp.concatenate([ub, jnp.full(1, F32_INF, ub.dtype)])

    nchunks = (cmax + chunk - 1) // chunk
    ids = jnp.pad(ids, (0, nchunks * chunk - cmax), constant_values=m)

    def body(t, state):
        lb_acc, ub_acc = state
        sel = jax.lax.dynamic_slice(ids, (t * chunk,), (chunk,))
        gi = jnp.take(ij_i_pad, sel)
        gj = jnp.take(ij_j_pad, sel)
        Ei = jnp.take(E, gi, axis=0)
        Ej = jnp.take(E, gj, axis=0)
        both = (Ei < F32_INF) & (Ej < F32_INF)
        lb_new = jnp.max(
            jnp.where(both, jnp.abs(Ei - Ej), 0.0), axis=1
        )
        ub_new = jnp.min(Ei + Ej, axis=1)
        lb_acc = lb_acc.at[sel].max(lb_new, mode="drop")
        ub_acc = ub_acc.at[sel].min(ub_new, mode="drop")
        return lb_acc, ub_acc

    lb2, ub2 = jax.lax.fori_loop(0, nchunks, body, (lb_pad, ub_pad))
    return lb2[:m], ub2[:m]


@jax.jit
def _scatter_exact(RA, ncm, ids, vals):
    """Land a batch of exact distances."""
    return RA.at[ids].set(vals), ncm.at[ids].set(False)


@jax.jit
def _override_rows(RA, ids, vals):
    """Non-metric anchor-row fixup (reference annchor.py:365-372)."""
    return RA.at[ids].set(vals)


def _row_block(nx: int, max_deg: int, budget: int = 1 << 27) -> int:
    """Row-block size keeping (block, max_deg) f32 temps under
    ~budget bytes — the dense incidence working set OOMs at
    nx * max_deg > ~10^9 otherwise."""
    b = max(256, budget // (4 * max(max_deg, 1)))
    return int(min(nx, b))


@functools.partial(
    jax.jit, static_argnames=("nn", "n_ref", "guarantee", "nmin")
)
def _select(
    RA, ncm, ij_i, ij_j, dad, P_idx,
    inner_edges, cdf_grid, cdf_lo, cdf_inv, cdf_hi,
    nn: int, n_ref: int, guarantee: bool, nmin: int,
):
    """Device refinement selection (reference annchor.py:395-473).

    Returns (chosen pair ids (n_ref,), per-point thresholds (nx,)).
    Selection = top n_ref by empirical probability of beating the
    endpoint threshold; computed pairs score -1 so they are never
    chosen.  Ties break by pair id (top_k is index-stable).

    The per-bin residual CDFs arrive pre-sampled on a fixed grid
    (cdf_grid (K, G), domain [cdf_lo, cdf_hi] per bin): one gather from
    a small table replaces a per-pair binary search into the raw
    residual arrays, which is gather-bound.

    The per-point passes over the incidence matrix run in row blocks
    (clamped dynamic slices; the tail block overlaps, which is safe —
    identical values are rewritten and the mark scatter is a max):
    the dense (nx, max_deg) gather temps would exceed HBM at
    nx >= ~5 * 10^4."""
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    RA_pad = jnp.concatenate([RA, jnp.array([F32_INF])])
    ncm_ext = jnp.concatenate([ncm, jnp.array([False])])
    kk = min(nn, max_deg - 1)
    blk = _row_block(nx, max_deg)
    nblk = (nx + blk - 1) // blk

    def thresh_body(t, acc):
        thresh_acc, marks_acc = acc
        start = jnp.minimum(t * blk, nx - blk)
        rows = jax.lax.dynamic_slice(P_idx, (start, 0), (blk, max_deg))
        vals = jnp.take(RA_pad, rows, axis=0)
        neg_topk, _ = jax.lax.top_k(-vals, kk + 1)
        thresh_acc = jax.lax.dynamic_update_slice(
            thresh_acc, -neg_topk[:, kk], (start,)
        )
        if guarantee:
            # force >= nmin computed-or-forced pairs per point
            # (reference utils.py:606-621): mark each point's smallest
            # uncomputed estimates so their margin becomes huge
            ncm_rows = jnp.take(ncm_ext, rows)
            todo_vals = jnp.where(ncm_rows, vals, F32_INF)
            n_computed = jnp.sum((~ncm_rows) & (rows < m), axis=1)
            n_todo = jnp.clip(nmin - n_computed, 0, max_deg - 1)
            svals = jnp.sort(todo_vals, axis=1)
            kth = jnp.take_along_axis(svals, n_todo[:, None], axis=1)
            mark_rows = (
                (todo_vals < kth) & ncm_rows & (n_todo[:, None] > 0)
            )
            marks_acc = marks_acc.at[rows.reshape(-1)].max(
                mark_rows.reshape(-1)
            )
        return thresh_acc, marks_acc

    thresh, marks = jax.lax.fori_loop(
        0, nblk, thresh_body,
        (
            jnp.zeros(nx, dtype=jnp.float32),
            jnp.zeros(m + 1 if guarantee else 1, dtype=bool),
        ),
    )
    RAg = RA
    if guarantee:
        RAg = jnp.where(marks[:m], jnp.float32(-1.0), RA)

    margin = (
        jnp.maximum(jnp.take(thresh, ij_i), jnp.take(thresh, ij_j)) - RAg
    )
    K, G = cdf_grid.shape
    labels = jnp.clip(
        jnp.searchsorted(inner_edges, dad, side="right"), 0, K - 1
    )
    lo = jnp.take(cdf_lo, labels)
    hi = jnp.take(cdf_hi, labels)
    inv = jnp.take(cdf_inv, labels)
    cell = jnp.clip(
        ((margin - lo) * inv).astype(jnp.int32), 0, G - 1
    )
    prob = jnp.take(cdf_grid.reshape(-1), labels * G + cell)
    prob = jnp.where(margin > hi, jnp.float32(1.0), prob)
    prob = jnp.where(margin < lo, jnp.float32(0.0), prob)
    prob = jnp.where(ncm, prob, jnp.float32(-1.0))
    _, chosen = jax.lax.top_k(prob, n_ref)
    # pair coordinates gathered in-program: the caller feeds them to
    # the metric engine without a second round trip
    return chosen, thresh, jnp.take(ij_i, chosen), jnp.take(ij_j, chosen)


@functools.partial(jax.jit, static_argnames=("nx", "block"))
def _tighten_full(ij_i, ij_j, RA, ncm, lb, ub, nx: int, block: int = 16):
    """Tropical self-product bound tightening, all on device.

    Every computed exact distance is a pseudo-anchor: with E the
    (nx, nx) computed-distance matrix,

        LB'[i,j] = max_y |E[i,y] - E[j,y]|   (both entries present)
        UB'[i,j] = min_y  E[i,y] + E[j,y]

    computed as a blocked min-plus/max-abs-diff product (elementwise;
    matrix units cannot help in the tropical semiring).  All pending pairs get the
    tightened interval — the reference could only afford its lookahead
    subset (annchor/annchor.py:486-511)."""
    d = jnp.where(ncm, jnp.float32(0), RA)
    ok = ~ncm
    E = jnp.zeros((nx, nx), dtype=jnp.float32)
    E = E.at[ij_i, ij_j].set(d, mode="drop")
    E = E.at[ij_j, ij_i].set(d, mode="drop")
    V = jnp.zeros((nx, nx), dtype=bool)
    V = V.at[ij_i, ij_j].set(ok, mode="drop")
    V = V.at[ij_j, ij_i].set(ok, mode="drop")
    Einf = jnp.where(V, E, F32_INF)
    Ezero = jnp.where(V, E, jnp.float32(0))

    nblk = (nx + block - 1) // block
    padn = nblk * block
    if padn != nx:
        Ezero = jnp.pad(Ezero, ((0, 0), (0, padn - nx)))
        V = jnp.pad(V, ((0, 0), (0, padn - nx)))
        Einf = jnp.pad(
            Einf, ((0, 0), (0, padn - nx)), constant_values=F32_INF
        )

    def body(t, acc):
        lb_acc, ub_acc = acc
        a = jax.lax.dynamic_slice(Ezero, (0, t * block), (nx, block))
        v = jax.lax.dynamic_slice(V, (0, t * block), (nx, block))
        i = jax.lax.dynamic_slice(Einf, (0, t * block), (nx, block))
        diff = jnp.abs(a[:, None, :] - a[None, :, :])
        both = v[:, None, :] & v[None, :, :]
        lb_acc = jnp.maximum(
            lb_acc, jnp.max(jnp.where(both, diff, 0.0), axis=2)
        )
        ub_acc = jnp.minimum(
            ub_acc, jnp.min(i[:, None, :] + i[None, :, :], axis=2)
        )
        return lb_acc, ub_acc

    lbM, ubM = jax.lax.fori_loop(
        0,
        nblk,
        body,
        (
            jnp.zeros((nx, nx), dtype=jnp.float32),
            jnp.full((nx, nx), F32_INF, dtype=jnp.float32),
        ),
    )
    lb_pair = lbM[ij_i, ij_j]
    ub_pair = ubM[ij_i, ij_j]
    lb2 = jnp.where(ncm, jnp.maximum(lb, lb_pair), lb)
    ub2 = jnp.where(ncm, jnp.minimum(ub, ub_pair), ub)
    return lb2, ub2


@jax.jit
def _clip_ra(RA, ncm, lb, ub):
    """Final re-clip of never-computed estimates into the tightened
    interval (see Annchor.finalise_bounds)."""
    return jnp.where(ncm, jnp.clip(RA, lb, ub), RA)


@functools.partial(jax.jit, static_argnames=("nn",))
def _knn(RA, ncm, P_idx, ij_i, ij_j, nn: int):
    """Graph assembly selection (reference get_nn, utils.py:383-429):
    uncomputed pairs carry a +rowmax penalty so computed pairs win.
    Returns (pair ids (nx, nn), neighbour indices, RA values) — the
    pair-to-neighbour mapping happens on device so the host never
    needs the incidence matrix.  Row-blocked like _select: the dense
    (nx, max_deg) temps OOM at large nx."""
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    RA_pad = jnp.concatenate([RA, jnp.array([F32_INF])])
    ncm_ext = jnp.concatenate([ncm, jnp.array([True])])
    pair_sum = jnp.concatenate(
        [(ij_i + ij_j).astype(jnp.int32), jnp.zeros(1, jnp.int32)]
    )
    blk = _row_block(nx, max_deg)
    nblk = (nx + blk - 1) // blk

    def body(t, acc):
        ids_acc, part_acc, ra_acc, cm_acc = acc
        start = jnp.minimum(t * blk, nx - blk)
        rows = jax.lax.dynamic_slice(P_idx, (start, 0), (blk, max_deg))
        vals = jnp.take(RA_pad, rows, axis=0)
        ncm_rows = jnp.take(ncm_ext, rows)
        valid = rows < m
        mx = jnp.max(
            jnp.where(valid, vals, -F32_INF), axis=1, keepdims=True
        )
        dpen = jnp.where(
            valid, vals + jnp.where(ncm_rows, mx, 0.0), F32_INF
        )
        _, cols = jax.lax.top_k(-dpen, nn)
        ra_sel = jnp.take_along_axis(vals, cols, axis=1)
        sel_cm = ~jnp.take_along_axis(ncm_rows, cols, axis=1)
        pair_ids = jnp.take_along_axis(rows, cols, axis=1)
        partners = jnp.take(pair_sum, pair_ids) - (
            start + jnp.arange(blk, dtype=jnp.int32)
        )[:, None]
        partners = jnp.where(pair_ids < m, partners, -1)
        ids_acc = jax.lax.dynamic_update_slice(
            ids_acc, pair_ids, (start, 0)
        )
        part_acc = jax.lax.dynamic_update_slice(
            part_acc, partners, (start, 0)
        )
        ra_acc = jax.lax.dynamic_update_slice(ra_acc, ra_sel, (start, 0))
        cm_acc = jax.lax.dynamic_update_slice(cm_acc, sel_cm, (start, 0))
        return ids_acc, part_acc, ra_acc, cm_acc

    ids0 = jnp.zeros((nx, nn), dtype=P_idx.dtype)
    part0 = jnp.zeros((nx, nn), dtype=jnp.int32)
    ra0 = jnp.zeros((nx, nn), dtype=jnp.float32)
    cm0 = jnp.zeros((nx, nn), dtype=bool)
    return jax.lax.fori_loop(0, nblk, body, (ids0, part0, ra0, cm0))


# ---------------------------------------------------------------------------
# device-resident extras: nearest-enemy graph + selective subset
# (reference annchor.py:685-940) — the per-point passes mirror _select
# / _knn but restrict to differently-labelled partners, so the extras
# run on the live fit state instead of forcing the O(m) host download


@jax.jit
def _member_lex(si, sj, qi, qj):
    """Membership of query pairs in a lexicographically sorted pair
    list, via an explicit vectorised binary search (int64 packed keys
    would need x64; (i, j) comparison needs none)."""
    m = si.shape[0]
    lo = jnp.zeros_like(qi)
    hi = jnp.full_like(qi, m)

    def body(_, lh):
        lo, hi = lh
        # lo + (hi - lo) // 2, not (lo + hi) // 2: the indices are
        # int32 (x64 off) and the sum overflows past m ~ 2^30
        mid = lo + (hi - lo) // 2
        c = jnp.clip(mid, 0, m - 1)
        mi = jnp.take(si, c)
        mj = jnp.take(sj, c)
        less = (mi < qi) | ((mi == qi) & (mj < qj))
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    # halvings sized to the (static) list length — 22 at m ~ 3M vs a
    # blanket 31; each halving is two m-wide gathers over every query
    nit = max(1, int(m - 1).bit_length()) if m > 0 else 1
    lo, hi = jax.lax.fori_loop(0, nit, body, (lo, hi))
    c = jnp.clip(lo, 0, m - 1)
    return (lo < m) & (jnp.take(si, c) == qi) & (jnp.take(sj, c) == qj)


@jax.jit
def _lexsort_pairs(ij_i, ij_j):
    perm = jnp.lexsort((ij_j, ij_i))
    return jnp.take(ij_i, perm), jnp.take(ij_j, perm)


@jax.jit
def _predict_pairs(lb, ub, dad, inner_edges, coefs, icepts):
    """Regression predict for appended pairs, clipped to bounds —
    device twin of the host predict in enemies.get_nearest_enemies
    (K-way select like _regress_update; bin convention (lo, hi])."""
    labels = jnp.searchsorted(inner_edges, dad, side="left")
    K = coefs.shape[0]
    pred = jnp.zeros_like(dad)
    for b in range(K):
        pred_b = (
            lb * coefs[b, 0]
            + ub * coefs[b, 1]
            + dad * coefs[b, 2]
            + icepts[b]
        )
        pred = jnp.where(labels == b, pred_b, pred)
    return jnp.clip(pred, lb, ub)


def _enemy_refine_body(RA_pad, ncm_ext, rows, pair_sum_ext, y, row0,
                       m: int, kk: int):
    """One row block of the enemy refine selection: the kk
    smallest-estimate differently-labelled candidates per point,
    returned as pair ids (sentinel m where not chosen / computed)."""
    blk = rows.shape[0]
    nx = y.shape[0]
    vals = jnp.take(RA_pad, rows, axis=0)
    valid = rows < m
    others = jnp.take(pair_sum_ext, rows) - (
        row0 + jnp.arange(blk, dtype=jnp.int32)
    )[:, None]
    yo = jnp.take(y, jnp.clip(others, 0, nx - 1))
    yrow = jnp.take(
        y, jnp.clip(row0 + jnp.arange(blk, dtype=jnp.int32), 0, nx - 1)
    )
    emask = valid & (yo != yrow[:, None])
    dmat = jnp.where(emask, vals, F32_INF)
    _, cols = jax.lax.top_k(-dmat, kk)
    ids_sel = jnp.take_along_axis(rows, cols, axis=1)
    sel_ok = (
        jnp.take_along_axis(emask, cols, axis=1)
        & jnp.take(ncm_ext, ids_sel)
    )
    return jnp.where(sel_ok, ids_sel, m)


@functools.partial(jax.jit, static_argnames=("k",))
def _enemy_refine_select(RA, ncm, P_idx, ij_i, ij_j, y, k: int):
    """Per point: its k closest *predicted* enemies among the tracked
    pairs that are still uncomputed (reference annchor.py:753-769).
    Row-blocked like _select/_knn."""
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    RA_pad = jnp.concatenate([RA, jnp.array([F32_INF])])
    ncm_ext = jnp.concatenate([ncm, jnp.array([False])])
    pair_sum_ext = jnp.concatenate(
        [(ij_i + ij_j).astype(jnp.int32), jnp.zeros(1, jnp.int32)]
    )
    kk = min(k, max_deg)
    blk = _row_block(nx, max_deg)
    nblk = (nx + blk - 1) // blk

    def body(t, acc):
        start = jnp.minimum(t * blk, nx - blk)
        rows = jax.lax.dynamic_slice(P_idx, (start, 0), (blk, max_deg))
        ids_sel = _enemy_refine_body(
            RA_pad, ncm_ext, rows, pair_sum_ext, y, start, m, kk
        )
        return jax.lax.dynamic_update_slice(acc, ids_sel, (start, 0))

    acc0 = jnp.full((nx, kk), m, dtype=P_idx.dtype)
    return jax.lax.fori_loop(0, nblk, body, acc0)


def _enemy_knn_body(RA_pad, ncm_ext, rows, pair_sum_ext, y, row0,
                    m: int, nn: int):
    """One row block of enemy-graph assembly: uncomputed AND
    same-label candidates carry a +rowmax penalty (reference
    annchor.py:771-787)."""
    blk = rows.shape[0]
    nx = y.shape[0]
    vals = jnp.take(RA_pad, rows, axis=0)
    ncm_rows = jnp.take(ncm_ext, rows)
    valid = rows < m
    others = jnp.take(pair_sum_ext, rows) - (
        row0 + jnp.arange(blk, dtype=jnp.int32)
    )[:, None]
    yo = jnp.take(y, jnp.clip(others, 0, nx - 1))
    yrow = jnp.take(
        y, jnp.clip(row0 + jnp.arange(blk, dtype=jnp.int32), 0, nx - 1)
    )
    same = yo == yrow[:, None]
    mx = jnp.max(jnp.where(valid, vals, -F32_INF), axis=1, keepdims=True)
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
    dpen = jnp.where(
        valid,
        vals
        + jnp.where(valid & ncm_rows, mx, 0.0)
        + jnp.where(valid & same, mx, 0.0),
        F32_INF,
    )
    _, cols = jax.lax.top_k(-dpen, nn)
    ra_sel = jnp.take_along_axis(
        jnp.where(valid, vals, F32_INF), cols, axis=1
    )
    pair_ids = jnp.take_along_axis(rows, cols, axis=1)
    partners = jnp.take_along_axis(others, cols, axis=1)
    # the host reference leaves `others` 0 where invalid
    partners = jnp.where(pair_ids < m, partners, 0)
    return pair_ids, partners, ra_sel


@functools.partial(jax.jit, static_argnames=("nn",))
def _enemy_knn(RA, ncm, P_idx, ij_i, ij_j, y, nn: int):
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    RA_pad = jnp.concatenate([RA, jnp.array([F32_INF])])
    ncm_ext = jnp.concatenate([ncm, jnp.array([True])])
    pair_sum_ext = jnp.concatenate(
        [(ij_i + ij_j).astype(jnp.int32), jnp.zeros(1, jnp.int32)]
    )
    blk = _row_block(nx, max_deg)
    nblk = (nx + blk - 1) // blk

    def body(t, acc):
        ids_acc, part_acc, ra_acc = acc
        start = jnp.minimum(t * blk, nx - blk)
        rows = jax.lax.dynamic_slice(P_idx, (start, 0), (blk, max_deg))
        pair_ids, partners, ra_sel = _enemy_knn_body(
            RA_pad, ncm_ext, rows, pair_sum_ext, y, start, m, nn
        )
        ids_acc = jax.lax.dynamic_update_slice(
            ids_acc, pair_ids, (start, 0)
        )
        part_acc = jax.lax.dynamic_update_slice(
            part_acc, partners, (start, 0)
        )
        ra_acc = jax.lax.dynamic_update_slice(ra_acc, ra_sel, (start, 0))
        return ids_acc, part_acc, ra_acc

    ids0 = jnp.zeros((nx, nn), dtype=P_idx.dtype)
    part0 = jnp.zeros((nx, nn), dtype=jnp.int32)
    ra0 = jnp.zeros((nx, nn), dtype=jnp.float32)
    return jax.lax.fori_loop(0, nblk, body, (ids0, part0, ra0))


def _cover_incidence_body(dists_pad, rows, pair_sum_ext, slot, radii,
                          row0, m: int, S: int):
    """One row block of subset-cover incidence: inc[b, s] = 1 iff
    subset member s (slot order) lies strictly inside point b's
    enemy radius among its tracked candidates."""
    blk = rows.shape[0]
    nx = slot.shape[0]
    d = jnp.take(dists_pad, rows)
    valid = rows < m
    others = jnp.take(pair_sum_ext, rows) - (
        row0 + jnp.arange(blk, dtype=jnp.int32)
    )[:, None]
    sl = jnp.take(slot, jnp.clip(others, 0, nx - 1))
    rr = jnp.take(
        radii, jnp.clip(row0 + jnp.arange(blk, dtype=jnp.int32), 0, nx - 1)
    )
    live = valid & (sl >= 0) & (d < rr[:, None] - 1e-6)
    col = jnp.where(live, sl, S)
    flat = (
        jnp.arange(blk, dtype=jnp.int32)[:, None] * (S + 1) + col
    ).reshape(-1)
    inc = jnp.zeros(blk * (S + 1), dtype=jnp.int32)
    inc = inc.at[flat].max(live.reshape(-1).astype(jnp.int32))
    return inc.reshape(blk, S + 1)[:, :S]


@functools.partial(jax.jit, static_argnames=("S",))
def _cover_incidence(RA, ncm, ub, P_idx, ij_i, ij_j, slot, radii, S: int):
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    dists_pad = jnp.concatenate(
        [jnp.where(ncm, ub, RA), jnp.array([F32_INF])]
    )
    pair_sum_ext = jnp.concatenate(
        [(ij_i + ij_j).astype(jnp.int32), jnp.zeros(1, jnp.int32)]
    )
    blk = _row_block(nx, max_deg)
    nblk = (nx + blk - 1) // blk

    def body(t, acc):
        start = jnp.minimum(t * blk, nx - blk)
        rows = jax.lax.dynamic_slice(P_idx, (start, 0), (blk, max_deg))
        inc = _cover_incidence_body(
            dists_pad, rows, pair_sum_ext, slot, radii, start, m, S
        )
        return jax.lax.dynamic_update_slice(acc, inc, (start, 0))

    acc0 = jnp.zeros((nx, S), dtype=jnp.int32)
    return jax.lax.fori_loop(0, nblk, body, acc0)


@jax.jit
def _gather_rows(lb, ub, dad, ids):
    return (
        jnp.take(lb, ids),
        jnp.take(ub, ids),
        jnp.take(dad, ids),
    )


@jax.jit
def _sample_gather(lb, ub, dad, ij_i, ij_j, ids):
    """Feature rows + pair coordinates for freshly drawn sample ids in
    one dispatch (ids may carry -1 padding; callers mask those rows
    after download).  Fusing this with the draw collapses the
    per-iteration sampling to a single device round trip — host
    synchronisation, not compute, dominates the small-nx fit."""
    c = jnp.clip(ids, 0, lb.shape[0] - 1)
    return (
        jnp.take(lb, c),
        jnp.take(ub, c),
        jnp.take(dad, c),
        jnp.take(ij_i, c),
        jnp.take(ij_j, c),
    )


# ---------------------------------------------------------------------------
# host-side driver object


class _ExactStore:
    """Sparse float64 store of computed pair distances, keyed by pair
    row id, kept id-sorted for O(log) batched lookup.  Replaces the
    dense m-sized host mirror on large fits (only the computed budget
    — a few million values — ever exists on the host)."""

    def __init__(self):
        self.ids = np.empty(0, np.int64)
        self.vals = np.empty(0, np.float64)

    def add(self, ids, vals):
        """Insert (deduplicated) values; re-adding an existing id
        refreshes its value instead of inserting a duplicate entry.
        Returns the number of genuinely new ids (the sampling/select
        budget decrements by this, so repeat ids cannot drift it)."""
        ids = np.asarray(ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        uids, first = np.unique(ids, return_index=True)
        uvals = vals[first]
        pos = np.searchsorted(self.ids, uids)
        if self.ids.shape[0]:
            pos_c = np.clip(pos, 0, self.ids.shape[0] - 1)
            exists = self.ids[pos_c] == uids
            if exists.any():
                self.vals[pos_c[exists]] = uvals[exists]
                uids, uvals, pos = (
                    uids[~exists], uvals[~exists], pos[~exists]
                )
        self.ids = np.insert(self.ids, pos, uids)
        self.vals = np.insert(self.vals, pos, uvals)
        return int(uids.shape[0])

    def lookup(self, q):
        """Values for pair ids `q` (NaN where not computed); any
        shape, applied elementwise."""
        q = np.asarray(q, dtype=np.int64)
        out = np.full(q.shape, np.nan)
        if self.ids.shape[0] == 0:
            return out
        pos = np.clip(np.searchsorted(self.ids, q), 0, self.ids.shape[0] - 1)
        hit = self.ids[pos] == q
        out[hit] = self.vals[pos[hit]]
        return out


@jax.jit
def _anchor_flag_dev(ij_i, ij_j, is_anchor):
    return jnp.take(is_anchor, ij_i) | jnp.take(is_anchor, ij_j)


@jax.jit
def _gather_pair_cols(ij_i, ij_j, ids):
    return jnp.take(ij_i, ids), jnp.take(ij_j, ids)


class DeviceFitState:
    """Device-resident pair state plus the host bookkeeping needed to
    keep the plug-in surface intact.  Small fits keep dense host
    mirrors (ncm and exact float64 values); large fits built by
    `candidate_pairs_device` run in *sparse-host* mode — the pair list
    never crosses the link, the not-computed mask lives only on
    device, and exact values sit in a sparse store sized by the eval
    budget instead of the pair count."""

    def __init__(self, ann):
        import os
        import time as _time

        _dbg = os.environ.get("ANNCHOR_TPU_DEBUG_TIMING")
        _t0 = _time.perf_counter()

        def _tick(label):
            nonlocal _t0
            if _dbg:
                t = _time.perf_counter()
                print("    [dev-init] %s: %.3f s" % (label, t - _t0))
                _t0 = t

        self.ann = ann
        nx = ann.nx
        ij_dev = getattr(ann, "_ij_dev", None)
        self.sparse = ij_dev is not None
        if self.sparse:
            self.ij_i, self.ij_j, self.m = ij_dev
        else:
            self.m = ann.IJs.shape[0]
            self.ij_i = jnp.asarray(ann.IJs[:, 0].astype(np.int32))
            self.ij_j = jnp.asarray(ann.IJs[:, 1].astype(np.int32))
            if _dbg:  # sync only when timing stages
                jax.block_until_ready((self.ij_i, self.ij_j))
        _tick("ij upload")

        # multi-chip: shard the whole pair state over the device mesh
        # (ops/sharded_fit.py); single-chip fits take the plain-jit
        # kernels below unchanged
        from annchor_tpu import parallel

        mesh = parallel.auto_mesh()
        self.shard = None
        if mesh is not None:
            from annchor_tpu.ops.sharded_fit import ShardedFit

            s = mesh.size
            m_pad = -(-self.m // s) * s
            nx_pad = -(-nx // s) * s
            self.shard = ShardedFit(mesh, self.m, m_pad, nx, nx_pad)
            # sentinel pairs (0, 0) are excluded everywhere by
            # `id < m` guards and ncm=False
            self.ij_i = self.shard.put_pairs(self.ij_i, fill=0)
            self.ij_j = self.shard.put_pairs(self.ij_j, fill=0)
        self.m_pad = self.m if self.shard is None else self.shard.m_pad
        _tick("shard placement")

        D32 = jnp.asarray(np.asarray(ann.D, dtype=np.float32))
        # keep the (chunk, na) gather working set ~0.5 GB
        fchunk = max(1 << 18, (1 << 27) // max(D32.shape[1], 1))
        if self.shard is not None:
            self.lb, self.ub, self.dad = self.shard.features(
                D32, self.ij_i, self.ij_j, chunk=fchunk
            )
        else:
            self.lb, self.ub, self.dad = _features_init(
                D32, self.ij_i, self.ij_j, chunk=fchunk
            )
        if _dbg:
            jax.block_until_ready((self.lb, self.ub, self.dad))
        _tick("features init")

        # conservative default: only _rebuild_pidx (the scale path,
        # where tighten_cols runs) certifies its matrix for the
        # incidence-based tighten panel build
        self._pidx_capped = True
        if self.m == nx * (nx - 1) // 2 and not self.sparse:
            # all-pairs candidate set: build the incidence matrix on
            # device from its closed form instead of uploading it
            self.P_idx_d = _pidx_full_dev(nx)
        elif self.sparse or getattr(ann, "_P_idx", None) is None:
            # large fits skip the host incidence matrix entirely:
            # build it on device by counting sort over the pair list;
            # hub degrees are capped to keep the matrix ~2 GB, keeping
            # each point's lowest-lower-bound candidates (shared with
            # the post-append rebuild)
            self._rebuild_pidx()
        else:
            self.P_idx_d = jnp.asarray(ann.P_idx)
        if self.shard is not None:
            # no-op when build_pidx already produced the sharded layout
            self.P_idx_d = self.shard.put_rows(self.P_idx_d)
        _tick("P_idx build")

        # anchor flag / not-computed mask / exact float64 values:
        # dense host mirrors on small fits, device + sparse store at
        # scale
        if len(ann.A):
            anchor_np = np.zeros(nx, dtype=bool)
            anchor_np[np.asarray(ann.A, dtype=int)] = True
        else:
            anchor_np = np.zeros(nx, dtype=bool)
        if self.sparse:
            self.anchor_flag = None
            self.ncm_host = None
            af = _anchor_flag_dev(
                self.ij_i, self.ij_j, jnp.asarray(anchor_np)
            )
            if self.m_pad > self.m:
                # sentinel pairs are neither anchors nor samplable
                real = jnp.arange(self.m_pad, dtype=jnp.int32) < self.m
                af = af & real
                self.ncm = (~af) & real
            else:
                self.ncm = ~af
            self.exact = _ExactStore()
            n_anchor_pairs = int(jnp.sum(af))
            self.pool = self.m - n_anchor_pairs
            self._anchor_ids = None
            if n_anchor_pairs:
                ids = np.asarray(
                    jnp.flatnonzero(af, size=n_anchor_pairs)
                ).astype(np.int64)
                self._anchor_ids = ids
                self._fill_anchor_exacts(ids)
        else:
            self.anchor_flag = (
                anchor_np[ann.IJs[:, 0]] | anchor_np[ann.IJs[:, 1]]
            )
            _tick("anchor flag host")
            self.ncm_host = ~self.anchor_flag
            if self.shard is not None:
                self.ncm = self.shard.put_pairs(
                    jnp.asarray(self.ncm_host), fill=False
                )
            else:
                self.ncm = jnp.asarray(self.ncm_host)
            self.pool = int(self.ncm_host.sum())
            self.exact64 = np.full(self.m, np.nan)
            ids = np.flatnonzero(self.anchor_flag)
            self._anchor_ids = ids if ids.shape[0] else None
            self._fill_anchor_exacts(ids)
        _tick("host mirrors")

        if self.shard is not None:
            # sentinel RA stays +inf (P_idx pad entries read "worse
            # than everything", matching the single-chip convention)
            self.RA = self.shard.put_pairs(
                jnp.zeros(self.m, dtype=jnp.float32), fill=F32_INF
            )
        else:
            self.RA = jnp.zeros(self.m, dtype=jnp.float32)
        self.thresh = None
        self._started = False
        self._pending_exact = []

        # non-metric fixup rows: anchor pairs must carry their exact
        # column values once predictions stop being bound-clipped
        self._override = None
        if not ann.is_metric and self._anchor_ids is not None:
            ids = self._anchor_ids
            vals = (
                self.exact.lookup(ids)
                if self.sparse
                else self.exact64[ids]
            )
            self._override = (
                jnp.asarray(ids.astype(np.int32)),
                jnp.asarray(vals.astype(np.float32)),
            )

    def _pairs_at(self, ids):
        """(len, 2) int64 host pair coordinates for pair row ids."""
        if not self.sparse:
            return self.ann.IJs[ids]
        idd = jnp.asarray(ids.astype(np.int32))
        if self.shard is not None:
            ii, jj = self.shard.gather_pairs(
                (self.ij_i, self.ij_j), idd
            )
        else:
            ii, jj = _gather_pair_cols(self.ij_i, self.ij_j, idd)
        return np.stack(
            [np.asarray(ii), np.asarray(jj)], axis=1
        ).astype(np.int64)

    def _store_exact(self, ids, vals):
        # pool decrements by the count of genuinely *new* pair ids so a
        # repeat/duplicate id can never drift the sampling budget
        ids = np.asarray(ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if self.sparse:
            n_new = self.exact.add(ids, vals)
        else:
            uids, first = np.unique(ids, return_index=True)
            n_new = int(np.count_nonzero(self.ncm_host[uids]))
            self.ncm_host[uids] = False
            self.exact64[uids] = vals[first]
        self.pool -= n_new

    def _fill_anchor_exacts(self, ids):
        """Anchor-pair rows are exact from the D columns (vectorised
        over the anchor-flag mask; no incidence matrix needed)."""
        ann = self.ann
        if not len(ann.A) or ids is None or not len(ids):
            return
        A = np.asarray(ann.A, dtype=int)
        col_of = np.full(ann.nx, -1, dtype=np.int64)
        col_of[A] = np.arange(len(A))
        IJ = self._pairs_at(ids)
        ii = IJ[:, 0]
        jj = IJ[:, 1]
        i_is_anchor = col_of[ii] >= 0
        other = np.where(i_is_anchor, jj, ii)
        col = np.where(i_is_anchor, col_of[ii], col_of[jj])
        vals = np.asarray(ann.D)[other, col]
        if self.sparse:
            self.exact.add(ids, vals)
        else:
            self.exact64[ids] = vals

    # -- stage methods ------------------------------------------------------

    def sample_rows(self, ids):
        """Feature rows for the fitted strategies (small download)."""
        idd = jnp.asarray(ids.astype(np.int32))
        if self.shard is not None:
            lb, ub, dad = self.shard.gather_pairs(
                (self.lb, self.ub, self.dad), idd
            )
        else:
            lb, ub, dad = _gather_rows(self.lb, self.ub, self.dad, idd)
        feats = np.empty((len(ids), 4), dtype=np.float64)
        feats[:, 0] = np.asarray(lb)
        feats[:, 1] = np.asarray(ub)
        feats[:, 2] = np.asarray(dad)
        if self.sparse:
            # sampled ids are drawn from the not-computed pool, which
            # excludes anchor pairs by construction
            feats[:, 3] = 0.0
        else:
            feats[:, 3] = self.anchor_flag[ids]
        return feats

    def _sample_rows_dev(self, ids_dev):
        """Feature rows + pair coordinates for device-resident sample
        ids — dispatched without waiting for the draw to download."""
        c = jnp.maximum(ids_dev, 0)
        if self.shard is not None:
            return self.shard.gather_pairs(
                (self.lb, self.ub, self.dad, self.ij_i, self.ij_j), c
            )
        return _sample_gather(
            self.lb, self.ub, self.dad, self.ij_i, self.ij_j, ids_dev
        )

    def draw_sample(self, sampler, n_samples, random_seed, batch_dev=None):
        """Stratified sample drawn on device.  The draw, the feature
        rows, the pair coordinates — and with ``batch_dev`` the exact
        sample distances too — come down in ONE device round trip
        (round-trip latency dominates at small nx); mirrors
        SimpleStratifiedSampler.sample (same budget warnings, same
        per-loop seed advance).

        Returns (ids, bins, features (n, 4), pair coords (n, 2),
        sample distances (n,) or None)."""
        from annchor_tpu.samplers import NothingToSample

        pool = self.pool
        if pool <= 0:
            raise NothingToSample()
        ilo, ihi, adjusted = sampler.plan(pool, n_samples)
        if adjusted != n_samples:
            print(
                "Warning: n_samples has changed from %d to %d."
                % (n_samples, adjusted)
            )
        if adjusted == 0:
            raise NothingToSample()
        P = sampler.n_partitions
        quotas = [adjusted // P] * P
        for b in range(adjusted % P):
            quotas[b] += 1

        key = jax.random.fold_in(
            jax.random.PRNGKey(random_seed), sampler.loop_num
        )
        sampler.loop_num += 1
        args = (
            self.dad, self.ncm, key,
            jnp.int32(min(ilo, pool - 1)),
            jnp.int32(min(ihi, pool - 1)),
            jnp.int32(pool),
        )
        if self.shard is not None:
            draw = self.shard.sample_draw
        else:
            draw = _sample_draw

        def run(quotas_t, **kw):
            ids_d, got_d, inner_d = draw(*args, quotas_t, **kw)
            rows_d = self._sample_rows_dev(ids_d)
            if batch_dev is not None:
                y_d = batch_dev(
                    rows_d[3].astype(jnp.int32),
                    rows_d[4].astype(jnp.int32),
                )
                return jax.device_get((ids_d, got_d, inner_d, rows_d, y_d))
            got = jax.device_get((ids_d, got_d, inner_d, rows_d))
            return got + (None,)

        ids, got, inner, rows, y = run(tuple(quotas))
        if got.min(initial=2) < 2:
            # linspace edges landed in density gaps (multimodal
            # distances): retry with equal-mass quantile edges, which
            # cannot produce empty bins, before degrading to uniform
            print(
                "Warning: stratification bins degenerate; "
                "switching to equal-mass bins."
            )
            ids, got, inner, rows, y = run(tuple(quotas), equal_mass=True)
            if got.min(initial=2) < 2:
                # last resort: uniform draw, keeping the equal-mass
                # edges for the downstream per-bin models
                print(
                    "Warning: stratification bins degenerate; "
                    "sampling uniformly."
                )
                ids, got, _, rows, y = run((adjusted,))
        ids = np.asarray(ids, dtype=np.int64)
        keep = ids >= 0
        ids = ids[keep]
        if ids.shape[0] != adjusted:
            print("Warning: Some bins contained fewer samples than requested")
        bins = np.concatenate(
            ([-np.inf], np.asarray(inner, np.float64), [np.inf])
        )
        lb, ub, dad, ii, jj = (np.asarray(r)[keep] for r in rows)
        feats = np.empty((ids.shape[0], 4), dtype=np.float64)
        feats[:, 0] = lb
        feats[:, 1] = ub
        feats[:, 2] = dad
        if self.sparse:
            # sampled ids come from the not-computed pool, which
            # excludes anchor pairs by construction
            feats[:, 3] = 0.0
        else:
            feats[:, 3] = self.anchor_flag[ids]
        IJ = np.stack([ii, jj], axis=1).astype(np.int64)
        if y is not None:
            y = np.asarray(y, dtype=np.float64)[keep]
        return ids, bins, feats, IJ, y

    def regress_update(self, regression, sample_ids, sample_y,
                       sample_features):
        """Upload the fitted coefficients, predict+clip every pair on
        device, land the sample exacts.  Returns the unclipped sample
        predictions (for the residual model), computed on host from the
        sample feature rows — the dispatch stays fully asynchronous
        (one fewer blocking round trip per iteration)."""
        inner = jnp.asarray(
            np.asarray(regression.sample_bins[1:-1], dtype=np.float32)
        )
        coefs = jnp.asarray(np.asarray(regression.coefs, np.float32))
        icepts = jnp.asarray(np.asarray(regression.intercepts, np.float32))
        sids = jnp.asarray(sample_ids.astype(np.int32))
        sy = jnp.asarray(sample_y.astype(np.float32))
        if self.shard is not None:
            self.RA, self.ncm = self.shard.regress_update(
                self.lb, self.ub, self.dad, self.RA, self.ncm,
                inner, coefs, icepts, sids, sy,
                self.ann.is_metric, not self._started,
                int(coefs.shape[0]),
            )
        else:
            self.RA, self.ncm = _regress_update(
                self.lb, self.ub, self.dad, self.RA, self.ncm,
                inner, coefs, icepts, sids, sy,
                self.ann.is_metric, not self._started,
            )
        self._started = True
        if self._override is not None:
            if self.shard is not None:
                self.RA = self.shard.override_rows(
                    self.RA, *self._override
                )
            else:
                self.RA = _override_rows(self.RA, *self._override)
        self._store_exact(sample_ids, sample_y)
        return predict_sample_host(regression, sample_features)

    CDF_GRID = 4096

    def _cdf_tables(self, error_predictor):
        """Sample each bin's empirical residual CDF onto a fixed grid
        (host; the raw per-bin arrays total a few thousand floats).
        Quantisation error is below the CDF's own 1/len step."""
        K = error_predictor.n_partitions
        G = self.CDF_GRID
        grid = np.zeros((K, G), dtype=np.float32)
        lo = np.full(K, np.inf, dtype=np.float32)
        hi = np.full(K, np.inf, dtype=np.float32)
        inv = np.zeros(K, dtype=np.float32)
        for b in range(K):
            e = np.asarray(error_predictor.errs.get(b, np.zeros(0)))
            if len(e) == 0:
                continue  # lo=+inf => every margin reads prob 0
            lo[b], hi[b] = e[0], e[-1]
            span = float(hi[b] - lo[b])
            if span > 0:
                inv[b] = (G - 1) / span
            xs = lo[b] + np.arange(G) / max(inv[b], 1e-30)
            grid[b] = np.searchsorted(e, xs) / len(e)
        return grid, lo, hi, inv

    def select(self, error_predictor, n_ref, nn, guarantee, nmin):
        """Device selection.  Returns (chosen pair ids, (n_ref, 2)
        pair coordinates) — coordinates are gathered in-program so the
        whole selection is one device round trip."""
        bins = error_predictor.partition_bins
        inner = jnp.asarray(np.asarray(bins[1:-1], dtype=np.float32))
        grid, lo, hi, inv = self._cdf_tables(error_predictor)

        n_ref = int(min(n_ref, self.pool))
        if n_ref <= 0:
            self.thresh = None
            empty = np.zeros(0, dtype=np.int64)
            return empty, np.zeros((0, 2), dtype=np.int64)
        if self.shard is not None:
            chosen, thresh, sel_i, sel_j = self.shard.select(
                self.RA, self.ncm, self.ij_i, self.ij_j, self.dad,
                self.P_idx_d, inner,
                jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(inv),
                jnp.asarray(hi),
                int(nn), n_ref, bool(guarantee), int(nmin),
            )
        else:
            chosen, thresh, sel_i, sel_j = _select(
                self.RA, self.ncm, self.ij_i, self.ij_j, self.dad,
                self.P_idx_d, inner,
                jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(inv),
                jnp.asarray(hi),
                int(nn), n_ref, bool(guarantee), int(nmin),
            )
        self.thresh = thresh  # device-resident; used by tighten
        chosen, sel_i, sel_j = jax.device_get((chosen, sel_i, sel_j))
        IJ = np.stack([sel_i, sel_j], axis=1).astype(np.int64)
        return np.asarray(chosen, dtype=np.int64), IJ

    def select_refine_fused(
        self, error_predictor, n_ref, nn, guarantee, nmin, batch_dev
    ):
        """Selection, device-id metric eval and the exact scatter as
        one dispatch chain with a single blocking download (ids +
        values for the host mirrors).  Host round trips dominate the
        per-iteration cost at small nx; the unfused path blocks 4-5
        times per iteration."""
        bins = error_predictor.partition_bins
        inner = jnp.asarray(np.asarray(bins[1:-1], dtype=np.float32))
        grid, lo, hi, inv = self._cdf_tables(error_predictor)

        n_ref = int(min(n_ref, self.pool))
        if n_ref <= 0:
            self.thresh = None
            return 0
        if self.shard is not None:
            chosen, thresh, sel_i, sel_j = self.shard.select(
                self.RA, self.ncm, self.ij_i, self.ij_j, self.dad,
                self.P_idx_d, inner,
                jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(inv),
                jnp.asarray(hi),
                int(nn), n_ref, bool(guarantee), int(nmin),
            )
        else:
            chosen, thresh, sel_i, sel_j = _select(
                self.RA, self.ncm, self.ij_i, self.ij_j, self.dad,
                self.P_idx_d, inner,
                jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(inv),
                jnp.asarray(hi),
                int(nn), n_ref, bool(guarantee), int(nmin),
            )
        self.thresh = thresh
        y = batch_dev(sel_i.astype(jnp.int32), sel_j.astype(jnp.int32))
        if self.shard is not None:
            self.RA, self.ncm = self.shard.scatter_exact(
                self.RA, self.ncm,
                chosen.astype(jnp.int32), y.astype(jnp.float32),
            )
        else:
            self.RA, self.ncm = _scatter_exact(
                self.RA, self.ncm, chosen, y.astype(jnp.float32)
            )
        # `chosen` is n_ref *distinct uncomputed* ids by construction
        # (computed pairs score -1 in _select and n_ref <= pool), so
        # the budget can be accounted immediately; the host mirrors
        # don't need these values until the final graph assembly, so
        # the download is deferred to one flush — the per-iteration
        # loop keeps a single blocking trip (the sample draw)
        self._pending_exact.append((chosen, y))
        self.pool -= n_ref
        return n_ref

    def _flush_exacts(self):
        """Land every deferred fused-select batch in the host mirrors
        with one blocking download (pool was already decremented at
        select time)."""
        if not self._pending_exact:
            return
        got = jax.device_get(self._pending_exact)
        self._pending_exact = []
        for ch, yv in got:
            ids = np.asarray(ch, np.int64)
            vals = np.asarray(yv, np.float64)
            if self.sparse:
                self.exact.add(ids, vals)
            else:
                self.ncm_host[ids] = False
                self.exact64[ids] = vals

    def seed_ra_from_store(self):
        """Scatter every stored exact value into the device RA.

        The first regression predict normally populates RA for every
        pair; when the fit loop ends before it runs (tiny pools: the
        sampler has nothing to draw on iteration 0), the anchor-pair
        exacts exist only in the host store and RA still holds its
        zeros init — the k-NN assembly would select garbage."""
        self._flush_exacts()
        if self.sparse:
            ids, vals = self.exact.ids, self.exact.vals
        else:
            ids = np.flatnonzero(~self.ncm_host).astype(np.int64)
            vals = self.exact64[ids]
        if ids.shape[0]:
            self.apply_exact(np.asarray(ids, np.int64), vals)

    def apply_exact(self, ids, vals):
        idd = jnp.asarray(ids.astype(np.int32))
        vd = jnp.asarray(np.asarray(vals, np.float32))
        if self.shard is not None:
            self.RA, self.ncm = self.shard.scatter_exact(
                self.RA, self.ncm, idd, vd
            )
        else:
            self.RA, self.ncm = _scatter_exact(self.RA, self.ncm, idd, vd)
        self._store_exact(ids, vals)

    TIGHTEN_NCOL = 2048  # pseudo-anchor columns at scale
    TIGHTEN_CMAX = 1 << 23  # contender pairs per tighten at scale

    def tighten(self):
        nx = self.ann.nx
        if nx <= MAX_FULL_MATRIX_NX:
            if self.shard is not None:
                self.lb, self.ub = self.shard.tighten_full(
                    self.ij_i, self.ij_j, self.RA, self.ncm,
                    self.lb, self.ub, nx,
                )
            else:
                self.lb, self.ub = _tighten_full(
                    self.ij_i, self.ij_j, self.RA, self.ncm,
                    self.lb, self.ub, nx,
                )
            return
        if self.thresh is None:
            return  # contender filter needs thresholds (post-select)
        if self.shard is not None:
            self.lb, self.ub = self.shard.tighten_cols(
                self.ij_i, self.ij_j, self.RA, self.ncm,
                self.lb, self.ub, self.thresh,
                min(self.TIGHTEN_NCOL, nx),
                int(min(self.TIGHTEN_CMAX, self.m)),
            )
        else:
            # an uncapped incidence matrix lets the panel build gather
            # the column points' rows (ncol*max_deg updates) instead
            # of scattering every pair twice (17x measured at 100k)
            pidx = None if getattr(self, "_pidx_capped", True) else (
                self.P_idx_d
            )
            self.lb, self.ub = _tighten_cols(
                self.ij_i, self.ij_j, self.RA, self.ncm,
                self.lb, self.ub, self.thresh,
                min(self.TIGHTEN_NCOL, nx),
                int(min(self.TIGHTEN_CMAX, self.m)),
                P_idx=pidx,
            )
        if self.sparse:
            # per-iteration barrier: without it the host races ahead
            # and several generations of the O(m) f32 state stay live
            # in device memory at once (observed runtime OOM at
            # m ~ 10^8)
            jax.block_until_ready((self.lb, self.ub))

    def finalise(self):
        self.tighten()
        if self.shard is not None:
            self.RA = self.shard.clip_ra(
                self.RA, self.ncm, self.lb, self.ub
            )
        else:
            self.RA = _clip_ra(self.RA, self.ncm, self.lb, self.ub)

    def knn_graph(self, nn):
        """Final k-NN graph; exact distances come from the host float64
        cache, predicted ones from the downloaded f32 estimates.

        Deliberately does NOT flush the deferred fused-select batches:
        per-edge exactness comes from the device ncm gather (`sel_cm`),
        and a computed edge whose value is still pending host-side uses
        the downloaded RA estimate — which is bit-identical to what the
        flush would store (the fused path scatters the same f32 eval
        into RA it defers for download, and the store merely upcasts
        it).  At 100k the flush is a several-hundred-MB download
        that graph assembly does not need; consumers that need the
        values host-side (save/refine/features/enemies) flush on
        entry."""
        nn = min(int(nn), int(self.P_idx_d.shape[1]))
        if self.shard is not None:
            pair_sum = (self.ij_i + self.ij_j).astype(jnp.int32)
            pair_ids, partners, ra_sel, sel_cm = self.shard.knn(
                self.RA, self.ncm, self.P_idx_d, pair_sum, nn
            )
        else:
            pair_ids, partners, ra_sel, sel_cm = _knn(
                self.RA, self.ncm, self.P_idx_d, self.ij_i, self.ij_j, nn
            )
        # one blocking download for all four result arrays
        pair_ids, partners, ra_sel, sel_cm = jax.device_get(
            (pair_ids, partners, ra_sel, sel_cm)
        )
        pair_ids = np.asarray(pair_ids, dtype=np.int64)
        ngi = np.asarray(partners, dtype=np.int64)
        ra_sel = np.asarray(ra_sel, dtype=np.float64)
        clipped = np.clip(pair_ids, 0, self.m - 1)
        exact = (
            self.exact.lookup(clipped)
            if self.sparse
            else self.exact64[clipped]
        )
        is_exact = (pair_ids < self.m) & np.asarray(sel_cm)
        # which reported edges carry exact vs predicted values — the
        # post-fit refine pass certifies the predicted ones first
        self.ng_exact_mask = is_exact
        ngd = np.where(is_exact & ~np.isnan(exact), exact, ra_sel)
        return ngi, ngd

    # -- device-resident extras (nearest enemies / selective subset) --------

    def tracked_mask(self, IJ):
        """Host bool mask: which query pairs (i < j) are already in
        the tracked pair list.  Lex-sorted device binary search — the
        O(m) pair list never crosses the link."""
        IJ = np.asarray(IJ)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        si, sj = _lexsort_pairs(self.ij_i, self.ij_j)
        qi = jnp.asarray(IJ[:, 0].astype(np.int32))
        qj = jnp.asarray(IJ[:, 1].astype(np.int32))
        return np.asarray(_member_lex(si, sj, qi, qj))

    def _rebuild_pidx(self):
        """Device incidence-matrix build: sentinel masking, the
        PIDX_BUDGET degree cap, and the shard/capped/plain dispatch.
        Called from __init__ and re-run after an append (degrees
        changed)."""
        ann = self.ann
        nx = ann.nx
        if self.shard is not None and self.m_pad > self.m:
            gid = jnp.arange(self.m_pad, dtype=jnp.int32)
            bij_i = jnp.where(gid < self.m, self.ij_i, nx)
            bij_j = jnp.where(gid < self.m, self.ij_j, nx)
        else:
            bij_i, bij_j = self.ij_i, self.ij_j
        max_deg = int(np.asarray(ann.P_cnt).max())
        budget = int(
            os.environ.get("ANNCHOR_TPU_PIDX_BUDGET", PIDX_BUDGET_ELEMS)
        )
        cap = max(2 * ann.n_neighbors, budget // max(nx, 1))
        deg = cap if max_deg > cap else max_deg
        # a capped incidence matrix drops hub pairs, so it cannot feed
        # the tighten panel build (which must see EVERY computed pair
        # at a column point); tighten() falls back to pair scatters
        self._pidx_capped = bool(max_deg > cap)
        if self.shard is not None:
            self.P_idx_d = self.shard.build_pidx(
                bij_i, bij_j, self.lb, nx, deg, max_deg > cap
            )
        elif max_deg > cap:
            self.P_idx_d = _pidx_from_pairs_capped(
                bij_i, bij_j, self.lb, nx, cap
            )
        else:
            self.P_idx_d = _pidx_from_pairs(bij_i, bij_j, nx, max_deg)

    def append_pairs(self, IJ_new, regression):
        """Append new candidate pairs (the nearest-enemy path's fresh
        enemy candidates) to the device state: features + regression
        predictions computed on device, anchor-touching pairs exact
        from the D columns, incidence matrix rebuilt.  Mirrors the
        host path in enemies.get_nearest_enemies / reference
        annchor.py:734-742 without materialising the O(m) state."""
        self._flush_exacts()
        ann = self.ann
        nx = ann.nx
        k = IJ_new.shape[0]
        if k == 0:
            return
        m_old = self.m
        ii = jnp.asarray(IJ_new[:, 0].astype(np.int32))
        jj = jnp.asarray(IJ_new[:, 1].astype(np.int32))
        D32 = jnp.asarray(np.asarray(ann.D, dtype=np.float32))
        fchunk = max(1 << 18, (1 << 27) // max(D32.shape[1], 1))
        lb2, ub2, dad2 = _features_init(D32, ii, jj, chunk=fchunk)
        pred = _predict_pairs(
            lb2, ub2, dad2,
            jnp.asarray(regression.sample_bins[1:-1].astype(np.float32)),
            jnp.asarray(regression.coefs.astype(np.float32)),
            jnp.asarray(regression.intercepts.astype(np.float32)),
        )

        # anchor-touching new pairs are exact from the D columns
        if len(ann.A):
            anchor_set = np.zeros(nx, dtype=bool)
            anchor_set[np.asarray(ann.A, dtype=int)] = True
            is_anchor = (
                anchor_set[IJ_new[:, 0]] | anchor_set[IJ_new[:, 1]]
            )
        else:
            is_anchor = np.zeros(k, dtype=bool)
        ncm_new = ~is_anchor

        def real(a):
            return a[: m_old] if a.shape[0] > m_old else a

        cat_ij_i = jnp.concatenate([real(self.ij_i), ii])
        cat_ij_j = jnp.concatenate([real(self.ij_j), jj])
        cat_lb = jnp.concatenate([real(self.lb), lb2])
        cat_ub = jnp.concatenate([real(self.ub), ub2])
        cat_dad = jnp.concatenate([real(self.dad), dad2])
        cat_RA = jnp.concatenate([real(self.RA), pred])
        cat_ncm = jnp.concatenate([real(self.ncm), jnp.asarray(ncm_new)])
        self.m = m_old + k
        if self.shard is not None:
            from annchor_tpu.ops.sharded_fit import ShardedFit

            s = self.shard.mesh.size
            m_pad = -(-self.m // s) * s
            self.shard = ShardedFit(
                self.shard.mesh, self.m, m_pad, nx, self.shard.nx_pad
            )
            self.ij_i = self.shard.put_pairs(cat_ij_i, fill=0)
            self.ij_j = self.shard.put_pairs(cat_ij_j, fill=0)
            self.lb = self.shard.put_pairs(cat_lb, fill=0)
            self.ub = self.shard.put_pairs(cat_ub, fill=F32_INF)
            self.dad = self.shard.put_pairs(cat_dad, fill=0)
            self.RA = self.shard.put_pairs(cat_RA, fill=F32_INF)
            self.ncm = self.shard.put_pairs(cat_ncm, fill=False)
        else:
            self.ij_i, self.ij_j = cat_ij_i, cat_ij_j
            self.lb, self.ub, self.dad = cat_lb, cat_ub, cat_dad
            self.RA, self.ncm = cat_RA, cat_ncm
        self.m_pad = self.m if self.shard is None else self.shard.m_pad

        # keep the orchestrator's pair-list view aligned with the
        # extended state: features/RA/ncm now have m rows, so ann.IJs
        # must too (save(), plug-ins, and _pairs_at in dense mode all
        # read it), and a cached host P_idx would be stale
        if ann._IJs is not None:
            ann._IJs = np.concatenate(
                [ann._IJs, np.asarray(IJ_new, dtype=ann._IJs.dtype)],
                axis=0,
            )
        if ann._ij_dev is not None:
            ann._ij_dev = (self.ij_i, self.ij_j, self.m)
        ann._P_idx = None

        # bookkeeping: sampling pool, exact values, host mirrors
        self.pool += int(ncm_new.sum())
        anchor_ids = m_old + np.flatnonzero(is_anchor).astype(np.int64)
        if not self.sparse:
            self.anchor_flag = np.concatenate(
                [self.anchor_flag, is_anchor]
            )
            self.ncm_host = np.concatenate([self.ncm_host, ncm_new])
            self.exact64 = np.concatenate(
                [self.exact64, np.full(k, np.nan)]
            )
        if self._anchor_ids is not None or anchor_ids.size:
            prev = (
                self._anchor_ids
                if self._anchor_ids is not None
                else np.zeros(0, dtype=np.int64)
            )
            self._anchor_ids = np.concatenate([prev, anchor_ids])
        if anchor_ids.size:
            self._fill_anchor_exacts(anchor_ids)
            if not self.sparse:
                self.ncm_host[anchor_ids] = False

        # incidence matrix: degrees changed, rebuild on device
        ann.P_cnt = (
            np.asarray(ann.P_cnt, dtype=np.int64)
            + np.bincount(IJ_new[:, 0], minlength=nx)
            + np.bincount(IJ_new[:, 1], minlength=nx)
        ).astype(np.int32)
        self._rebuild_pidx()

    def enemy_refine_ids(self, y_codes, k=50):
        """Pair ids of each point's k closest predicted enemies that
        are still uncomputed (deduplicated, host int64)."""
        self._flush_exacts()
        y = jnp.asarray(np.asarray(y_codes, dtype=np.int32))
        if self.shard is not None:
            pair_sum = (self.ij_i + self.ij_j).astype(jnp.int32)
            ids = self.shard.enemy_refine(
                self.RA, self.ncm, self.P_idx_d, pair_sum, y, k
            )
        else:
            ids = _enemy_refine_select(
                self.RA, self.ncm, self.P_idx_d,
                self.ij_i, self.ij_j, y, k,
            )
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        return np.unique(ids[ids < self.m])

    def enemy_knn_graph(self, y_codes, nn):
        """Assemble the nearest-enemy graph on device (device twin of
        the row-blocked host assembly in enemies.get_nearest_enemies).
        Exact distances come from the float64 store like knn_graph."""
        self._flush_exacts()
        nn = min(int(nn), int(self.P_idx_d.shape[1]))
        y = jnp.asarray(np.asarray(y_codes, dtype=np.int32))
        if self.shard is not None:
            pair_sum = (self.ij_i + self.ij_j).astype(jnp.int32)
            pair_ids, partners, ra_sel = self.shard.enemy_knn(
                self.RA, self.ncm, self.P_idx_d, pair_sum, y, nn
            )
        else:
            pair_ids, partners, ra_sel = _enemy_knn(
                self.RA, self.ncm, self.P_idx_d,
                self.ij_i, self.ij_j, y, nn,
            )
        pair_ids, partners, ra_sel = jax.device_get(
            (pair_ids, partners, ra_sel)
        )
        pair_ids = np.asarray(pair_ids, dtype=np.int64)
        ngi = np.asarray(partners, dtype=np.int64)
        ra_sel = np.asarray(ra_sel, dtype=np.float64)
        clipped = np.clip(pair_ids, 0, self.m - 1)
        exact = (
            self.exact.lookup(clipped)
            if self.sparse
            else self.exact64[clipped]
        )
        is_exact = (pair_ids < self.m) & ~np.isnan(exact)
        ngd = np.where(is_exact, exact, ra_sel)
        return ngi, ngd

    def cover_incidence(self, slot, radii):
        """(nx, S) 0/1 incidence of subset members strictly inside
        each point's enemy radius among its tracked candidates (the
        selective-subset prune's working set; S = subset size)."""
        self._flush_exacts()
        S = int(np.asarray(slot).max()) + 1
        slot_d = jnp.asarray(np.asarray(slot, dtype=np.int32))
        radii_d = jnp.asarray(np.asarray(radii, dtype=np.float32))
        if self.shard is not None:
            dists = jnp.where(self.ncm, self.ub, self.RA)
            pair_sum = (self.ij_i + self.ij_j).astype(jnp.int32)
            inc = self.shard.cover_incidence(
                dists, self.P_idx_d, pair_sum, slot_d, radii_d, S
            )
        else:
            inc = _cover_incidence(
                self.RA, self.ncm, self.ub, self.P_idx_d,
                self.ij_i, self.ij_j, slot_d, radii_d, S,
            )
        return np.asarray(inc, dtype=np.int64)

    # -- host materialisation (plug-in / persistence surface) ---------------

    def ncm_to_host(self):
        """Dense host not-computed mask (downloaded on demand in
        sparse mode)."""
        self._flush_exacts()
        if self.ncm_host is not None:
            return self.ncm_host
        return np.asarray(self.ncm)[: self.m]

    def materialise(self):
        """Download the f32 state and hand back float64 host arrays
        (exact values keep full precision from the host cache;
        sentinel shard padding is sliced off)."""
        self._flush_exacts()
        lb = np.asarray(self.lb, dtype=np.float64)[: self.m]
        ub = np.asarray(self.ub, dtype=np.float64)[: self.m]
        if self.sparse:
            af = np.zeros(self.m, dtype=np.float64)
            if self._anchor_ids is not None:
                af[self._anchor_ids] = 1.0
        else:
            af = self.anchor_flag.astype(np.float64)
        features = np.stack(
            [lb, ub, np.asarray(self.dad, dtype=np.float64)[: self.m], af],
            axis=1,
        )
        RA = np.asarray(self.RA, dtype=np.float64)[: self.m]
        if self.sparse:
            RA[self.exact.ids] = self.exact.vals
            return features, RA, self.ncm_to_host()
        have = ~np.isnan(self.exact64)
        RA[have] = self.exact64[have]
        return features, RA, self.ncm_host.copy()
