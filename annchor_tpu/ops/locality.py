"""Candidate-pair generation from anchor localities.

The reference computes, for every point, the set of its `locality`
nearest anchors, then admits pair (i, j) as a k-NN candidate iff the
two sets share enough anchors — with a per-row adaptive threshold that
guarantees at least `loc_min` candidates per point, and a final
symmetrisation (reference annchor/annchor.py:208-256,
annchor/utils.py:437-491).

Device formulation: the shared-anchor count matrix is a binary matmul
S @ S.T on the matrix units; the symmetrised candidate test collapses to

    counts[i, j] >= min(eff[i], eff[j])          (i < j)

because counts is symmetric and the reference unions row-wise sets.

Two scale-critical tricks:

* counts are small integers in [0, locality], so the per-row
  "(loc_min+1)-th largest count" that drives the adaptive threshold is
  a locality-bin histogram — kth = #{c >= 1 : |counts_row >= c| >
  loc_min} — instead of an O(nx * loc_min) lax.top_k;
* the keep mask is bit-packed on device (uint8 via an 8-wide matmul)
  before transfer, an 8x saving on the host round trip.

Everything runs in row blocks so nx >> 10^4 never materialises an
nx x nx matrix.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from annchor_tpu.ops.features import anchor_membership


def _decode_packed(packed_u32, nx, row_off=0):
    """Packed-mask block -> (rows, cols).  Native single-pass decoder
    when the C++ library is available, numpy unpackbits otherwise."""
    try:
        from annchor_tpu import native

        if native.available():
            return native.unpack_pairs(packed_u32, nx, row_off)
    except Exception:
        pass
    bytes_ = np.ascontiguousarray(packed_u32).view(np.uint8)
    keep = np.unpackbits(bytes_, axis=1, bitorder="little")[:, :nx]
    r, c = np.nonzero(keep)
    return (r + row_off).astype(np.int32), c.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("loc_min", "locality"))
def _block_kth(S, S_block, loc_min: int, locality: int, mask_cols=None):
    """Per-row (loc_min+1)-th largest shared-anchor count for a block
    of rows, via the integer-histogram trick."""
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    counts = jax.lax.dot_general(
        S_block,
        S,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (B, nx)
    cvals = counts if mask_cols is None else jnp.where(mask_cols, counts, -1.0)
    kth = jnp.zeros(cvals.shape[0], dtype=jnp.float32)
    for c in range(1, locality + 1):
        ge_c = jnp.sum(cvals >= c, axis=1)
        kth = kth + (ge_c > loc_min)
    return kth


@functools.partial(jax.jit, static_argnames=())
def _block_keep_packed(S, S_block, eff_block, eff_all, row_off):
    """Bit-packed symmetrised candidate mask for a row block.

    keep[i, j] = counts[i, j] >= min(eff[i], eff[j]) and j > i.
    Returns uint32 (B, nx/32) with bit b of word w = column 32w+b.
    """
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    counts = jax.lax.dot_general(
        S_block,
        S,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    nx = counts.shape[1]
    thr = jnp.minimum(eff_block[:, None], eff_all[None, :])
    col_ids = jnp.arange(nx, dtype=jnp.int32)[None, :]
    row_ids = row_off + jnp.arange(
        counts.shape[0], dtype=jnp.int32
    )[:, None]
    keep = (counts >= thr) & (col_ids > row_ids)
    # pack 32 columns per uint32 word
    B = keep.shape[0]
    bits = keep.reshape(B, nx // 32, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * weights[None, None, :], axis=2, dtype=jnp.uint32)


def effective_thresholds(
    S, loc_thresh: float, loc_min: int, block: int = 4096,
    label_mask=None, locality: int | None = None, label_neq=None,
):
    """Per-row effective threshold eff[i] = min(loc_thresh, kth_largest_i).

    label_mask: optional (nx, nx)-broadcastable bool restricting which
    columns count toward the loc_min guarantee (used by the
    nearest-enemy path, reference annchor.py:713-717).
    label_neq: scale-safe alternative — a label vector y; the mask
    ``y[i] != y[j]`` is built per row block on device so no (nx, nx)
    host array ever exists.
    """
    S = jnp.asarray(S)
    nx = S.shape[0]
    if locality is None:
        locality = int(np.asarray(S).sum(axis=1).max())
    y_dev = None
    if label_neq is not None:
        _, codes = np.unique(np.asarray(label_neq), return_inverse=True)
        y_dev = jnp.asarray(codes.astype(np.int32))
    # uniform block shapes: one compile per kernel, not one per
    # remainder block
    nblk = min(block, nx)
    eff = np.zeros(nx, dtype=np.float32)
    for s in range(0, nx, nblk):
        e = min(s + nblk, nx)
        Sb = S[s:e]
        if e - s < nblk:
            Sb = jnp.pad(Sb, ((0, nblk - (e - s)), (0, 0)))
        if y_dev is not None:
            yb = y_dev[s:e]
            if e - s < nblk:
                yb = jnp.pad(yb, (0, nblk - (e - s)), constant_values=-1)
            mask_cols = yb[:, None] != y_dev[None, :]
        elif label_mask is None:
            mask_cols = None
        else:
            mb = np.asarray(label_mask[s:e])
            if e - s < nblk:
                mb = np.pad(mb, ((0, nblk - (e - s)), (0, 0)))
            mask_cols = jnp.asarray(mb)
        kth = _block_kth(S, Sb, loc_min, locality, mask_cols)
        eff[s:e] = np.asarray(kth)[: e - s]
    return np.minimum(np.float32(loc_thresh), eff)


@functools.partial(
    jax.jit, static_argnames=("locality", "loc_min", "loc_thresh")
)
def _fused_locality(D32, locality: int, loc_min: int, loc_thresh: int):
    """Whole locality stage in one program for single-block sizes:
    membership top-k, histogram-trick adaptive thresholds, symmetrised
    keep mask (bit-packed) and its population count.  One dispatch
    instead of three — dispatch+sync round trips dominate at small nx."""
    nx, na = D32.shape
    _, sid = jax.lax.top_k(-D32, locality)
    S = jnp.zeros((nx, na), dtype=jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(nx)[:, None], sid.shape)
    S = S.at[rows, sid].set(1.0)

    # 0/1 operands, f32 sums: exact at default (TF32) precision

    counts = jax.lax.dot_general(
        S, S,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    kth = jnp.zeros(nx, dtype=jnp.float32)
    for c in range(1, locality + 1):
        kth = kth + (jnp.sum(counts >= c, axis=1) > loc_min)
    eff = jnp.minimum(jnp.float32(loc_thresh), kth)

    thr = jnp.minimum(eff[:, None], eff[None, :])
    ids = jnp.arange(nx, dtype=jnp.int32)
    keep = (counts >= thr) & (ids[None, :] > ids[:, None])
    total = jnp.sum(keep)
    padc = (-nx) % 32
    if padc:
        keep = jnp.pad(keep, ((0, 0), (0, padc)))
    B, W = keep.shape[0], keep.shape[1] // 32
    bits = keep.reshape(B, W, 32).astype(jnp.uint32)
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(bits * weights[None, None, :], axis=2, dtype=jnp.uint32)
    return S, sid, eff, packed, total


def candidate_pairs(
    D,
    locality: int,
    loc_thresh: int,
    loc_min: int,
    block: int = 4096,
):
    """Symmetrised candidate pair list from anchor distances.

    Returns (IJs int32 (m, 2) with IJs[:,0] < IJs[:,1], sid, S, eff).
    sid: (nx, locality) nearest-anchor ids (reference self.sid);
    S: binary membership matrix (transpose of reference Amatrix).
    """
    import os
    import time as _time

    _dbg = os.environ.get("ANNCHOR_TPU_DEBUG_TIMING")
    nx = np.asarray(D).shape[0]
    if nx <= block:
        _t0 = _time.perf_counter()
        D32 = jnp.asarray(np.asarray(D), dtype=jnp.float32)
        S, sid, eff, packed, total = _fused_locality(
            D32, min(int(locality), int(D32.shape[1])),
            int(loc_min), int(loc_thresh)
        )
        # one blocking download for the mask + count; S/sid/eff stay
        # device-resident (nothing in the fit reads them — the caller
        # materialises lazily for query/enemies/persistence)
        packed_h, total = jax.device_get((packed, total))
        total = int(total)
        if _dbg:
            print(
                "    [locality] fused+sync: %.3f s"
                % (_time.perf_counter() - _t0)
            )
            _t0 = _time.perf_counter()
        if total == nx * (nx - 1) // 2:
            # every pair admitted: skip the unpack/nonzero round trip
            iu = np.triu_indices(nx, k=1)
            IJs = np.stack(iu, axis=1).astype(np.int32)
            if _dbg:
                print(
                    "    [locality] allkept host: %.3f s"
                    % (_time.perf_counter() - _t0)
                )
            return IJs, sid, S, eff
        r, c = _decode_packed(np.asarray(packed_h), nx)
        IJs = np.stack([r, c], axis=1).astype(np.int32)
        return IJs, sid, S, eff

    _t0 = _time.perf_counter()

    def _tick(label):
        nonlocal _t0
        if _dbg:
            t = _time.perf_counter()
            print("    [locality] %s: %.3f s" % (label, t - _t0))
            _t0 = t

    S, sid = anchor_membership(D, locality)
    if _dbg:
        jax.block_until_ready(S)
    _tick("membership")
    eff = effective_thresholds(
        S, loc_thresh, loc_min, block=block, locality=locality
    )
    _tick("eff thresholds")
    eff_j = jnp.asarray(eff)

    # pad the column axis to a multiple of 32 for bit packing
    pad_cols = (-nx) % 32
    S_pad = S
    if pad_cols:
        S_pad = jnp.pad(S, ((0, pad_cols), (0, 0)))
        eff_pad = jnp.asarray(
            np.concatenate([eff, np.full(pad_cols, np.inf, np.float32)])
        )
    else:
        eff_pad = eff_j

    try:
        from annchor_tpu import native

        have_native = native.available()
    except Exception:
        have_native = False

    # each packed block is decoded as it arrives and discarded — the
    # decoded pairs (8 B each) are the only retained O(m) state, never
    # the full nx^2/8-byte packed mask (GB-scale at large nx)
    nblk = min(block, nx)
    parts = []  # (m_blk, 2) int32 per block
    for s in range(0, nx, nblk):
        e = min(s + nblk, nx)
        Sb = S[s:e]
        eb = eff_j[s:e]
        if e - s < nblk:  # uniform shapes: single compile per kernel
            Sb = jnp.pad(Sb, ((0, nblk - (e - s)), (0, 0)))
            eb = jnp.pad(eb, (0, nblk - (e - s)),
                         constant_values=np.float32(np.inf))
        packed = np.asarray(
            _block_keep_packed(S_pad, Sb, eb, eff_pad, np.int32(s))
        )[: e - s]  # (B, (nx+pad)/32) uint32
        if have_native:
            blk = np.empty((native.count_pairs(packed), 2), np.int32)
            n = native.unpack_pairs_into(packed, nx, s, blk)
            parts.append(blk[:n])
        else:
            r, c = _decode_packed(packed, nx, row_off=s)
            parts.append(np.stack([r, c], axis=1))
        _tick("block %d pack+decode" % (s // nblk))

    IJs = (
        np.concatenate(parts) if parts else np.zeros((0, 2), np.int32)
    )
    _tick("assemble")
    return IJs, np.asarray(sid), np.asarray(S), eff


@functools.partial(jax.jit, static_argnames=())
def _block_keep_total(S, S_block, eff_block, eff_all, row_off):
    """Population count of the symmetrised keep mask for a row block
    (first pass of the device-side pair-list builder)."""
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    counts = jax.lax.dot_general(
        S_block, S,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    nx = counts.shape[1]
    thr = jnp.minimum(eff_block[:, None], eff_all[None, :])
    col_ids = jnp.arange(nx, dtype=jnp.int32)[None, :]
    row_ids = row_off + jnp.arange(
        counts.shape[0], dtype=jnp.int32
    )[:, None]
    keep = (counts >= thr) & (col_ids > row_ids)
    # block totals are < nblk * nx < 2^31 by the caller's block choice
    return jnp.sum(keep, dtype=jnp.int32), jnp.sum(
        keep, axis=0, dtype=jnp.int32
    ), jnp.sum(keep, axis=1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap",))
def _block_keep_extract(S, S_block, eff_block, eff_all, row_off, cap: int):
    """Pair coordinates of the keep mask for a row block, entirely on
    device: flatnonzero with a static capacity (bucketed so only a few
    distinct shapes ever compile).  Rows beyond the true count carry
    fill index 0 and are sliced off by the caller."""
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    counts = jax.lax.dot_general(
        S_block, S,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    nx = counts.shape[1]
    thr = jnp.minimum(eff_block[:, None], eff_all[None, :])
    col_ids = jnp.arange(nx, dtype=jnp.int32)[None, :]
    row_ids = row_off + jnp.arange(
        counts.shape[0], dtype=jnp.int32
    )[:, None]
    keep = (counts >= thr) & (col_ids > row_ids)
    flat = jnp.flatnonzero(keep, size=cap, fill_value=0)
    i = row_off + (flat // nx).astype(jnp.int32)
    j = (flat % nx).astype(jnp.int32)
    return i, j


def _cap_bucket(n: int) -> int:
    """Round a block pair count up to a coarse geometric grid so the
    extract kernel compiles for only a handful of shapes."""
    if n <= 1 << 16:
        return 1 << 16
    p = 1 << (int(n - 1).bit_length() - 1)
    for c in (p + p // 4, p + p // 2, p + 3 * (p // 4), 2 * p):
        if n <= c:
            return c
    return 2 * p


def candidate_pairs_device(
    D,
    locality: int,
    loc_thresh: int,
    loc_min: int,
    block: int = 4096,
    verbose: bool = False,
    max_resident: int | None = None,
    budget_cap: int | None = None,
):
    """`candidate_pairs`, but the pair list is built and stays on
    device (the scale path: nothing O(m) touches the host, no mask
    download, no pair upload).

    With ``max_resident``/``budget_cap`` set, the cheap counting pass
    decides the build: an admitted set larger than ``max_resident``
    pairs would OOM the fit's O(m) device state, so the build falls
    through to the two-pass budgeted stream keeping each point's
    ``budget_cap`` smallest-lower-bound candidates (resident pairs
    O(nx * cap) however permissive the filter).

    Returns (ij_i, ij_j, m, sid, S, eff, P_cnt) where ij_i/ij_j are
    int32 device arrays of length m with ij_i < ij_j, and P_cnt is the
    host per-point candidate count (for the loc_min failure check and
    incidence capacity)."""
    nx = np.asarray(D).shape[0]
    S, sid = anchor_membership(D, locality)
    eff = effective_thresholds(
        S, loc_thresh, loc_min, block=block, locality=locality
    )
    eff_j = jnp.asarray(eff)

    # block to bound the (B, nx) counts matrix; also keeps flat block
    # indices within int32 (B * nx < 2^31)
    nblk = min(block, nx)
    while nblk * nx > (1 << 31) - 1 and nblk > 256:
        nblk //= 2

    from annchor_tpu.progress import progress

    totals, pc_cols, pc_rows = [], [], []
    blocks = []
    for s in progress(
        range(0, nx, nblk), "pair-count blocks", verbose
    ):
        e = min(s + nblk, nx)
        Sb = S[s:e]
        eb = eff_j[s:e]
        if e - s < nblk:  # uniform shapes: single compile per kernel
            Sb = jnp.pad(Sb, ((0, nblk - (e - s)), (0, 0)))
            eb = jnp.pad(eb, (0, nblk - (e - s)),
                         constant_values=np.float32(np.inf))
        t, pc_c, pc_r = _block_keep_total(S, Sb, eb, eff_j, np.int32(s))
        blocks.append((s, Sb, eb))
        totals.append(t)
        pc_cols.append(pc_c)
        pc_rows.append(pc_r)
    totals = [int(t) for t in totals]
    if (
        max_resident is not None
        and budget_cap is not None
        and sum(totals) > max_resident
    ):
        # the admitted set would OOM the fit's O(m) device state:
        # hand the precomputed membership to the budgeted stream
        if verbose:
            print(
                "locality: %d admitted pairs > %d resident budget; "
                "switching to the budgeted build (cap %d per point)"
                % (sum(totals), max_resident, budget_cap)
            )
        return candidate_pairs_device_budgeted(
            D, locality, loc_thresh, loc_min, budget_cap,
            block=block, verbose=verbose, _pre=(S, sid, eff),
        )
    P_cnt = np.asarray(
        sum(pc_cols[1:], pc_cols[0])
    ) + np.concatenate([np.asarray(r) for r in pc_rows])[:nx]
    P_cnt = P_cnt.astype(np.int32)

    parts_i, parts_j = [], []
    for (s, Sb, eb), t in progress(
        list(zip(blocks, totals)), "pair-extract blocks", verbose
    ):
        if t == 0:
            continue
        cap = _cap_bucket(t)
        bi, bj = _block_keep_extract(S, Sb, eb, eff_j, np.int32(s), cap)
        parts_i.append(bi[:t])
        parts_j.append(bj[:t])
    if parts_i:
        ij_i = jnp.concatenate(parts_i)
        ij_j = jnp.concatenate(parts_j)
    else:
        ij_i = jnp.zeros(0, jnp.int32)
        ij_j = jnp.zeros(0, jnp.int32)
    m = int(sum(totals))
    return ij_i, ij_j, m, np.asarray(sid), np.asarray(S), eff, P_cnt


@functools.partial(jax.jit, static_argnames=("chunk",))
def _pairs_lb(D32, ij_i, ij_j, chunk: int = 1 << 21):
    """Triangle lower bounds for a pair list, chunked in-program (the
    (m, na) gather temps are the memory hazard at band scale)."""
    m = ij_i.shape[0]
    chunk = min(chunk, max(m, 1))
    nchunks = (m + chunk - 1) // chunk
    padm = nchunks * chunk
    gi_all = jnp.pad(ij_i, (0, padm - m))
    gj_all = jnp.pad(ij_j, (0, padm - m))

    def body(t, lb):
        gi = jax.lax.dynamic_slice(gi_all, (t * chunk,), (chunk,))
        gj = jax.lax.dynamic_slice(gj_all, (t * chunk,), (chunk,))
        Di = jnp.take(D32, gi, axis=0)
        Dj = jnp.take(D32, gj, axis=0)
        lb_c = jnp.max(jnp.abs(Di - Dj), axis=1)
        return jax.lax.dynamic_update_slice(lb, lb_c, (t * chunk,))

    lb = jax.lax.fori_loop(
        0, nchunks, body, jnp.zeros(padm, dtype=jnp.float32)
    )
    return lb[:m]


@functools.partial(jax.jit, static_argnames=("nbins",))
def _hist_update(hist, ij_i, ij_j, lb, inv_bin, nbins: int):
    """Fold a band's pair lower bounds into the per-point histogram."""
    b = jnp.clip((lb * inv_bin).astype(jnp.int32), 0, nbins - 1)
    hist = hist.at[ij_i, b].add(1, mode="drop")
    return hist.at[ij_j, b].add(1, mode="drop")


@functools.partial(jax.jit, static_argnames=("nbins",))
def _hist_thresholds(hist, cap, bin_w, nbins: int):
    """Per-point lb threshold admitting >= cap pairs (bin-resolution
    conservative: the NEXT bin edge above the cap-th smallest lb).
    Points with fewer than cap candidates keep everything (+inf)."""
    cum = jnp.cumsum(hist, axis=1)
    reached = cum >= cap
    first = jnp.argmax(reached, axis=1)
    thr = (first.astype(jnp.float32) + 1.0) * bin_w
    return jnp.where(reached[:, -1], thr, jnp.float32(np.inf))


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_kept(ij_i, ij_j, keep, cap: int):
    ids = jnp.flatnonzero(keep, size=cap, fill_value=0)
    return jnp.take(ij_i, ids), jnp.take(ij_j, ids)


@functools.partial(jax.jit, static_argnames=())
def _keep_counts(keep, ij_i, ij_j, nx_arr):
    w = keep.astype(jnp.int32)
    cnt = nx_arr.at[ij_i].add(w, mode="drop")
    return cnt.at[ij_j].add(w, mode="drop")


# ---------------------------------------------------------------------------
# Dense-band kernels for the budgeted build.
#
# jnp.flatnonzero(size=...) lowers to cumsum + a bincount SCATTER over
# every element of the band mask (~4e8 updates per 4096-row band at
# nx=1e5), and the per-pair histogram / count folds are scatters too —
# profiled as the build's bottleneck on the first accelerator this ran
# on (benchmarks/profile_budget_build.py).  The dense twins below compute
# the SAME math (same f32 triangle lower bounds, same binning, same
# bin-conservative threshold rule, same int counts) with reductions
# only, so results are bit-identical to the pair-fold kernels above:
#
# * `_band_bins_sym` — binned lower bounds of a row band against all
#   columns, dense, chunked in-program; the symmetric row view (every
#   admitted partner of row p appears in p's row) carries the same
#   per-point multiset the upper-triangular pair fold scatters into
#   both endpoints.
# * `_band_thr_from_bins` — per-row threshold via log2(nbins)-step
#   batched bisection over the binned matrix: the first bin whose
#   cumulative count reaches the cap, exactly `_hist_thresholds`'
#   argmax(cumsum >= cap).
# * `_band_keep2_dense` — pass-2 keep mask (upper-triangular admitted
#   & lb under either endpoint's threshold) plus per-point counts as
#   row/column sums (replacing the `_keep_counts` scatter).
# ---------------------------------------------------------------------------


def _band_score(Db, Dc, score: str):
    """(B, C) ranking score panel for a band-vs-chunk pair block.

    "linf": the triangle lower bound max_k |D_i,k - D_j,k| — a dense
    (B, C, na) elementwise broadcast, the budgeted build's wall at
    nx >= 5e5 when last profiled.
    "rms": sqrt(mean_k (D_i,k - D_j,k)^2) — the same [0, 2*Dmax]
    range (rms <= linf <= 2*Dmax) but in matmul form
    (|a|^2 + |b|^2 - 2ab) so the na reduction rides the matrix units;
    ~na x less elementwise work per band.  The cap then ranks candidates by RMS
    anchor-profile difference instead of the provable bound — a
    different (not bit-identical) tracked set; recall parity is
    validated by benchmark before use."""
    if score == "rms":
        na = Db.shape[1]
        # full f32: |a|^2 + |b|^2 - 2ab cancels worst on the nearest
        # pairs, which TF32's 10-bit mantissa would misrank
        cross = jax.lax.dot_general(
            Db, Dc,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        sq_r = jnp.sum(Db * Db, axis=1)
        sq_c = jnp.sum(Dc * Dc, axis=1)
        l2sq = sq_r[:, None] + sq_c[None, :] - 2.0 * cross
        return jnp.sqrt(jnp.maximum(l2sq, 0.0) / np.float32(na))
    return jnp.max(jnp.abs(Db[:, None, :] - Dc[None, :, :]), axis=2)


@functools.partial(
    jax.jit, static_argnames=("nbins", "cchunk", "score")
)
def _band_bins_sym(
    D32, S, Sb, Db, eb, eff_all, row_off, inv_bin, nbins: int,
    cchunk: int = 2048, score: str = "linf",
):
    """int16 (B, nx_pad) binned ranking scores for a row band,
    symmetric admitted view; sentinel `nbins` marks non-candidates.

    Caller pads the column axis of D32/S/eff_all to a multiple of
    `cchunk` (padded points have zero membership rows, so they are
    never admitted) and the band rows of Sb/Db to the block size the
    same way the pair-fold loop does."""
    B = Sb.shape[0]
    nxp = S.shape[0]
    nchunks = nxp // cchunk
    rows = row_off + jnp.arange(B, dtype=jnp.int32)

    def body(c, out):
        c0 = c * cchunk
        Sc = jax.lax.dynamic_slice(S, (c0, 0), (cchunk, S.shape[1]))
        # 0/1 operands, f32 sums: exact at default (TF32) precision
        counts = jax.lax.dot_general(
            Sb, Sc,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        ec = jax.lax.dynamic_slice(eff_all, (c0,), (cchunk,))
        thr = jnp.minimum(eb[:, None], ec[None, :])
        cols = c0 + jnp.arange(cchunk, dtype=jnp.int32)
        adm = (counts >= thr) & (cols[None, :] != rows[:, None])
        Dc = jax.lax.dynamic_slice(
            D32, (c0, 0), (cchunk, D32.shape[1])
        )
        lb = _band_score(Db, Dc, score)
        b = jnp.clip((lb * inv_bin).astype(jnp.int32), 0, nbins - 1)
        binc = jnp.where(adm, b, nbins).astype(jnp.int16)
        return jax.lax.dynamic_update_slice(out, binc, (0, c0))

    out = jax.lax.fori_loop(
        0, nchunks, body,
        jnp.full((B, nxp), nbins, dtype=jnp.int16),
    )
    return out


@functools.partial(jax.jit, static_argnames=("nbins",))
def _band_thr_from_bins(BINs, cap, bin_w, nbins: int):
    """Per-row lb threshold from the binned band: first bin whose
    cumulative count reaches `cap` (bin-conservative, identical to
    `_hist_thresholds`), +inf for rows with fewer than cap candidates."""
    kept = jnp.sum(BINs < nbins, axis=1, dtype=jnp.int32)
    B = BINs.shape[0]
    lo = jnp.zeros(B, dtype=jnp.int32)
    hi = jnp.full(B, nbins - 1, dtype=jnp.int32)
    # batched bisection: invariant f(hi) >= cap for reached rows
    for _ in range(int(nbins - 1).bit_length()):
        mid = (lo + hi) // 2
        cnt = jnp.sum(
            BINs <= mid[:, None].astype(jnp.int16), axis=1,
            dtype=jnp.int32,
        )
        hit = cnt >= cap
        hi = jnp.where(hit, mid, hi)
        lo = jnp.where(hit, lo, mid + 1)
    thr = (lo.astype(jnp.float32) + 1.0) * bin_w
    return jnp.where(kept >= cap, thr, jnp.float32(np.inf))


@functools.partial(jax.jit, static_argnames=("cchunk", "score"))
def _band_keep2_dense(
    D32, S, Sb, Db, eb, eff_all, thr_all, row_off, cchunk: int = 2048,
    score: str = "linf",
):
    """Pass-2 keep mask for a row band, dense: upper-triangular
    admitted pairs whose lb is under either endpoint's threshold.

    Returns (keep (B, nx_pad) bool, rowcnt (B,), colcnt (nx_pad,),
    kept total) — the counts replace the `_keep_counts` scatter with
    plain reductions."""
    B = Sb.shape[0]
    nxp = S.shape[0]
    nchunks = nxp // cchunk
    rows = row_off + jnp.arange(B, dtype=jnp.int32)
    thr_rows = jax.lax.dynamic_slice(thr_all, (row_off,), (B,))

    def body(c, keep):
        c0 = c * cchunk
        Sc = jax.lax.dynamic_slice(S, (c0, 0), (cchunk, S.shape[1]))
        # 0/1 operands, f32 sums: exact at default (TF32) precision
        counts = jax.lax.dot_general(
            Sb, Sc,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        ec = jax.lax.dynamic_slice(eff_all, (c0,), (cchunk,))
        thr = jnp.minimum(eb[:, None], ec[None, :])
        cols = c0 + jnp.arange(cchunk, dtype=jnp.int32)
        adm = (counts >= thr) & (cols[None, :] > rows[:, None])
        Dc = jax.lax.dynamic_slice(
            D32, (c0, 0), (cchunk, D32.shape[1])
        )
        lb = _band_score(Db, Dc, score)
        tc = jax.lax.dynamic_slice(thr_all, (c0,), (cchunk,))
        kc = adm & (lb <= jnp.maximum(thr_rows[:, None], tc[None, :]))
        return jax.lax.dynamic_update_slice(keep, kc, (0, c0))

    keep = jax.lax.fori_loop(
        0, nchunks, body, jnp.zeros((B, nxp), dtype=bool)
    )
    rowcnt = jnp.sum(keep, axis=1, dtype=jnp.int32)
    colcnt = jnp.sum(keep, axis=0, dtype=jnp.int32)
    return keep, rowcnt, colcnt, jnp.sum(rowcnt, dtype=jnp.int32)


@jax.jit
def _accum_band_counts(P_cnt, rowcnt, colcnt, row_off):
    """Fold a band's per-point counts into the accumulator: column
    sums add everywhere, row sums add at the band's row offset."""
    P_cnt = P_cnt + colcnt
    cur = jax.lax.dynamic_slice(P_cnt, (row_off,), (rowcnt.shape[0],))
    return jax.lax.dynamic_update_slice(P_cnt, cur + rowcnt, (row_off,))


# max elements of the dense (rows, nx) panel a single extraction
# program may sort/scan: int32 values + top_k workspace put its HBM
# peak at ~3x this in bytes*4.  2^28 => ~1 GB sort input, ~3 GB peak.
# Module-level so tests can shrink it to exercise the row-slice path.
_EXTRACT_ELEMS = 1 << 28


@functools.partial(jax.jit, static_argnames=("cap",))
def _extract_dense(keep, row_off, cap: int):
    """Pair coordinates of a dense band keep mask, row-major order
    (identical to the pair-fold path's flatnonzero-then-filter order)."""
    nxp = keep.shape[1]
    flat = jnp.flatnonzero(keep, size=cap, fill_value=0)
    i = row_off + (flat // nxp).astype(jnp.int32)
    j = (flat % nxp).astype(jnp.int32)
    return i, j


@functools.partial(jax.jit, static_argnames=("K", "cap"))
def _extract_dense_topk(keep, row_off, K: int, cap: int):
    """Same pair list as `_extract_dense` via per-row top-k: each
    row's set columns in ascending order (scores nxp - col are unique
    per column), then one small flatnonzero over the (B, K) valid mask
    instead of the (B, nx) one.  Requires K >= max per-row count."""
    B, nxp = keep.shape
    cols = jnp.arange(nxp, dtype=jnp.int32)
    vals = jnp.where(keep, nxp - cols[None, :], 0)
    v, _ = jax.lax.top_k(vals, K)  # descending = col ascending
    valid = v > 0
    flat = jnp.flatnonzero(valid, size=cap, fill_value=0)
    i = row_off + (flat // K).astype(jnp.int32)
    j = (nxp - jnp.take(v.ravel(), flat)).astype(jnp.int32)
    return i, j


_SHARDED_BUILD_CACHE: dict = {}


class _ShardedBudgetedBuild:
    """Sharded twin of the budgeted two-pass band loop: the mesh's s
    chips each process one whole row band per program call (band
    ``g*s + chip``), so band throughput scales with the mesh and the
    per-group blocking downloads replace s per-band ones.

    Bit-identity with the single-chip loop is by construction: the
    keep masks and triangle lower bounds are the same math per band,
    the lb histogram / P_cnt partials are int32 adds (associative
    exactly) psum-combined once, and the kept pairs concatenate in
    band order (group ascending, chip ascending == band ascending)
    with the same in-band flatnonzero order.
    """

    def __init__(self, mesh, nblk: int, nx: int, na: int, nbins: int):
        from jax.sharding import NamedSharding, PartitionSpec

        from annchor_tpu.parallel import PAIR_AXIS

        self.mesh = mesh
        self.axis = PAIR_AXIS
        self.s = mesh.size
        self.nblk = nblk
        self.nx = nx
        self.na = na
        self.nbins = nbins
        self.P = PartitionSpec
        self.sh_part = NamedSharding(mesh, PartitionSpec(PAIR_AXIS))
        self._cache = {}

    @classmethod
    def get(cls, mesh, nblk, nx, na, nbins):
        key = (
            tuple(d.id for d in mesh.devices.flat),
            nblk, nx, na, nbins,
        )
        inst = _SHARDED_BUILD_CACHE.get(key)
        if inst is None:
            inst = _SHARDED_BUILD_CACHE[key] = cls(mesh, nblk, nx, na, nbins)
        return inst

    def _shmap(self, fn, in_specs, out_specs):
        return jax.jit(
            jax.shard_map(
                fn,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                check_vma=False,
            )
        )

    def _band_keep(self, g, S_rows, eff_rows, S, eff_all):
        """(keep, row_off) for this chip's band of group g."""
        c = jax.lax.axis_index(self.axis)
        row_off = (g * self.s + c) * self.nblk
        Sb = jax.lax.dynamic_slice(
            S_rows, (row_off, 0), (self.nblk, self.na)
        )
        eb = jax.lax.dynamic_slice(eff_rows, (row_off,), (self.nblk,))
        # 0/1 operands, f32 sums: exact at default (TF32) precision
        counts = jax.lax.dot_general(
            Sb, S,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        thr = jnp.minimum(eb[:, None], eff_all[None, :])
        col_ids = jnp.arange(self.nx, dtype=jnp.int32)[None, :]
        row_ids = row_off + jnp.arange(self.nblk, dtype=jnp.int32)[:, None]
        keep = (counts >= thr) & (col_ids > row_ids)
        return keep, row_off

    def totals(self, g, S_rows, eff_rows, S, eff_all):
        """Per-chip admitted-pair counts for group g: host (s,)."""
        P = self.P

        def build():
            def body(g, S_rows, eff_rows, S, eff_all):
                keep, _ = self._band_keep(g, S_rows, eff_rows, S, eff_all)
                return jnp.sum(keep, dtype=jnp.int32).reshape(1)

            return self._shmap(
                body, (P(),) * 5, P(self.axis)
            )

        fn = self._cache.get("totals")
        if fn is None:
            fn = self._cache["totals"] = build()
        return np.asarray(
            fn(jnp.int32(g), S_rows, eff_rows, S, eff_all)
        )

    def _extracted(self, g, S_rows, eff_rows, S, eff_all, D32, cap):
        keep, row_off = self._band_keep(g, S_rows, eff_rows, S, eff_all)
        t = jnp.sum(keep, dtype=jnp.int32)
        flat = jnp.flatnonzero(keep, size=cap, fill_value=0)
        pos_ok = jnp.arange(cap, dtype=jnp.int32) < t
        bi = row_off + (flat // self.nx).astype(jnp.int32)
        bj = (flat % self.nx).astype(jnp.int32)
        bi = jnp.where(pos_ok, bi, 0)
        bj = jnp.where(pos_ok, bj, 0)
        lb = _pairs_lb(D32, bi, bj)
        return bi, bj, lb, pos_ok

    def hist_update(self, g, S_rows, eff_rows, S, eff_all, D32,
                    hist_part, cap: int, inv_bin, nbins: int):
        """Fold group g's band lower bounds into the per-chip partial
        histogram (sharded (s*nx, nbins); psum-combined once at the
        end of pass 1)."""
        P = self.P

        def build():
            def body(g, S_rows, eff_rows, S, eff_all, D32, hist):
                bi, bj, lb, pos_ok = self._extracted(
                    g, S_rows, eff_rows, S, eff_all, D32, cap
                )
                b = jnp.clip(
                    (lb * inv_bin).astype(jnp.int32), 0, nbins - 1
                )
                w = pos_ok.astype(jnp.int32)
                hist = hist.at[bi, b].add(w, mode="drop")
                return hist.at[bj, b].add(w, mode="drop")

            return self._shmap(
                body,
                (P(),) * 6 + (P(self.axis),),
                P(self.axis),
            )

        fn = self._cache.get(("hist", cap))
        if fn is None:
            fn = self._cache[("hist", cap)] = build()
        return fn(jnp.int32(g), S_rows, eff_rows, S, eff_all, D32,
                  hist_part)

    def combine_hist(self, hist_part):
        P = self.P

        def build():
            def body(hist):
                return jax.lax.psum(hist, self.axis)

            return self._shmap(body, (P(self.axis),), P())

        fn = self._cache.get("combine_hist")
        if fn is None:
            fn = self._cache["combine_hist"] = build()
        return fn(hist_part)

    def pass2(self, g, S_rows, eff_rows, S, eff_all, D32, thr,
              pcnt_part, cap: int):
        """Re-extract group g, keep pairs under either endpoint's lb
        threshold, compact per chip.  Returns (ki, kj, kept,
        pcnt_part): ki/kj global (s*cap,) with chip c's valid prefix at
        [c*cap : c*cap + kept[c]]."""
        P = self.P

        def build():
            def body(g, S_rows, eff_rows, S, eff_all, D32, thr, pcnt):
                bi, bj, lb, pos_ok = self._extracted(
                    g, S_rows, eff_rows, S, eff_all, D32, cap
                )
                keep = pos_ok & (
                    lb <= jnp.maximum(jnp.take(thr, bi), jnp.take(thr, bj))
                )
                w = keep.astype(jnp.int32)
                pcnt = pcnt.at[bi].add(w, mode="drop")
                pcnt = pcnt.at[bj].add(w, mode="drop")
                kept = jnp.sum(keep, dtype=jnp.int32)
                ids = jnp.flatnonzero(keep, size=cap, fill_value=0)
                return (
                    jnp.take(bi, ids),
                    jnp.take(bj, ids),
                    kept.reshape(1),
                    pcnt,
                )

            A = P(self.axis)
            return self._shmap(
                body,
                (P(),) * 7 + (A,),
                (A, A, A, A),
            )

        fn = self._cache.get(("pass2", cap))
        if fn is None:
            fn = self._cache[("pass2", cap)] = build()
        return fn(jnp.int32(g), S_rows, eff_rows, S, eff_all, D32, thr,
                  pcnt_part)

    def combine_pcnt(self, pcnt_part):
        P = self.P

        def build():
            def body(pcnt):
                return jax.lax.psum(pcnt, self.axis)

            return self._shmap(body, (P(self.axis),), P())

        fn = self._cache.get("combine_pcnt")
        if fn is None:
            fn = self._cache["combine_pcnt"] = build()
        return fn(pcnt_part)


def _budgeted_bands_sharded(
    mesh, D32, S, eff_j, per_point_cap: int, nblk: int, nx: int,
    nbins: int, inv_bin, bin_w, verbose: bool,
):
    """Both budgeted-build passes distributed over the device mesh:
    chip c of group g processes whole band ``g*s + c``.  Returns
    (ij_i, ij_j, m, P_cnt) bit-identical to the single-chip band loop
    (pinned by tests/test_sharded_fit.py)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from annchor_tpu.progress import progress

    s = mesh.size
    S = jnp.asarray(S)
    na = int(S.shape[1])
    sb = _ShardedBudgetedBuild.get(mesh, nblk, nx, na, nbins)
    nbands = -(-nx // nblk)
    ngroups = -(-nbands // s)
    rows_pad = ngroups * s * nblk
    repl = NamedSharding(mesh, PartitionSpec())
    # padded rows carry global row ids >= nx, excluded by the
    # col > row guard in the keep mask (same guard as the single-chip
    # loop's padded tail rows)
    S_rows = jax.device_put(
        jnp.pad(S, ((0, rows_pad - nx), (0, 0))), repl
    )
    eff_rows = jax.device_put(
        jnp.pad(eff_j, (0, rows_pad - nx),
                constant_values=np.float32(np.inf)),
        repl,
    )
    S_r = jax.device_put(S, repl)
    eff_all = jax.device_put(eff_j, repl)
    D32 = jax.device_put(D32, repl)

    # ---- pass 1: per-chip partial lb histograms ----------------------
    hist_part = jax.device_put(
        jnp.zeros((s * nx, nbins), jnp.int32), sb.sh_part
    )
    group_caps = []
    for g in progress(
        range(ngroups), "pair-budget pass 1 (sharded)", verbose
    ):
        # the (s,) totals download doubles as the per-group barrier
        # bounding in-flight band state (same role as the single-chip
        # loop's per-band total)
        tg = sb.totals(g, S_rows, eff_rows, S_r, eff_all)
        tmax = int(tg.max())
        if tmax == 0:
            group_caps.append(None)
            continue
        cap = _cap_bucket(tmax)
        group_caps.append(cap)
        hist_part = sb.hist_update(
            g, S_rows, eff_rows, S_r, eff_all, D32, hist_part,
            cap, inv_bin, nbins,
        )
    hist = sb.combine_hist(hist_part)
    del hist_part
    thr = _hist_thresholds(hist, jnp.int32(per_point_cap), bin_w, nbins)
    del hist
    thr = jax.device_put(thr, repl)

    # ---- pass 2: keep under-threshold pairs, band order preserved ----
    pcnt_part = jax.device_put(
        jnp.zeros(s * nx, jnp.int32), sb.sh_part
    )
    parts_i, parts_j = [], []
    m = 0
    for g in progress(
        range(ngroups), "pair-budget pass 2 (sharded)", verbose
    ):
        cap = group_caps[g]
        if cap is None:
            continue
        ki, kj, kept, pcnt_part = sb.pass2(
            g, S_rows, eff_rows, S_r, eff_all, D32, thr, pcnt_part, cap
        )
        keptg = np.asarray(kept)
        for c in range(s):
            kc = int(keptg[c])
            if kc == 0:
                continue
            parts_i.append(ki[c * cap : c * cap + kc])
            parts_j.append(kj[c * cap : c * cap + kc])
            m += kc
    P_cnt = np.asarray(sb.combine_pcnt(pcnt_part)).astype(np.int32)
    if parts_i:
        ij_i = jnp.concatenate(parts_i)
        ij_j = jnp.concatenate(parts_j)
    else:
        ij_i = jnp.zeros(0, jnp.int32)
        ij_j = jnp.zeros(0, jnp.int32)
    return ij_i, ij_j, m, P_cnt


def candidate_pairs_device_budgeted(
    D,
    locality: int,
    loc_thresh: int,
    loc_min: int,
    per_point_cap: int,
    block: int = 4096,
    nbins: int = 256,
    verbose: bool = False,
    _pre=None,
):
    """Two-pass streaming pair build: tracked pairs bounded by the
    *budgeted* set (each point's `per_point_cap` smallest-lower-bound
    candidates), not the filter-admitted set.

    Pass 1 streams row bands of the admitted mask, extracts each
    band's pairs on device, computes their triangle lower bounds and
    folds them into a per-point lb histogram — O(nx * nbins) state,
    never O(m_admitted).  Pass 2 derives a per-point lb threshold
    admitting >= cap candidates (bin-conservative) and re-streams the
    bands keeping pairs under either endpoint's threshold.  This lifts
    the single-chip memory wall at nx ~ 10^5: permissive filter
    configs whose admitted set is 10^8+ pairs stream through while the
    resident pair state stays O(nx * cap) — and the lb criterion keeps
    exactly the candidates the downstream ranking would have spent its
    budget on.

    Returns (ij_i, ij_j, m, sid, S, eff, P_cnt) like
    candidate_pairs_device."""
    from annchor_tpu.progress import progress

    nx = np.asarray(D).shape[0]
    if _pre is not None:
        # membership + thresholds precomputed by the counting pass
        # that decided to budget (candidate_pairs_device)
        S, sid, eff = _pre
    else:
        S, sid = anchor_membership(D, locality)
        eff = effective_thresholds(
            S, loc_thresh, loc_min, block=block, locality=locality
        )
    eff_j = jnp.asarray(eff)
    D32 = jnp.asarray(np.asarray(D), dtype=jnp.float32)
    # cap-ranking score: "linf" (default) = triangle lower bound;
    # "rms" = matmul form (see _band_score) — opt-in via env for
    # the single-chip scale path (the sharded pair-fold twins compute
    # linf, so rms + multi-chip falls back with a note)
    score = os.environ.get("ANNCHOR_TPU_BUILD_SCORE", "linf")
    if score not in ("linf", "rms"):
        score = "linf"
    if score == "rms":
        # the RMS statistic concentrates with the anchor count (CLT):
        # at na=192 the 256-bin histogram put most candidates in a
        # handful of bins and the bin-conservative threshold admitted
        # far past the cap (measured: 500k pass-2 bands ballooned
        # 10x).  Finer bins restore admitted ~ cap; the dense path's
        # per-band state is (B, nxp) int16 regardless of nbins, so
        # the only cost is log2(nbins) bisection steps.
        nbins = max(nbins, 8192)
    lb_max = float(2.0 * np.asarray(D).max()) + 1e-6
    inv_bin = np.float32(nbins / lb_max)
    bin_w = np.float32(lb_max / nbins)

    nblk = min(block, nx)
    while nblk * nx > (1 << 31) - 1 and nblk > 256:
        nblk //= 2

    # multi-chip: distribute whole bands over the mesh (chip c of
    # group g owns band g*s + c); bit-identical to the single-chip
    # loop below (ANNCHOR_TPU_NO_SHARDED_BUILD opts out)
    mesh = None
    if not os.environ.get("ANNCHOR_TPU_NO_SHARDED_BUILD"):
        from annchor_tpu import parallel

        mesh = parallel.auto_mesh()
    if mesh is not None and mesh.size > 1:
        if score != "linf" and verbose:
            print("    [locality] rms score unsupported on the mesh "
                  "path; using linf")
        ij_i, ij_j, m, P_cnt = _budgeted_bands_sharded(
            mesh, D32, S, eff_j, per_point_cap, nblk, nx, nbins,
            inv_bin, bin_w, verbose,
        )
        return (
            ij_i, ij_j, m, np.asarray(sid), np.asarray(S), eff, P_cnt,
        )

    # ---- single-chip: dense band passes (reductions only) ------------
    # jnp.flatnonzero / .at[].add lower to per-element SCATTERS
    # (benchmarks/profile_budget_build.py), so the pair-fold
    # formulation was scatter-bound.  The dense twins compute the same f32
    # lower bounds, binning, threshold rule and int counts with matmuls
    # and reductions; the sharded build (above) keeps the pair-fold
    # kernels and the equality test pins the two implementations to
    # each other (tests/test_sharded_fit.py).
    nxp = ((nx + nblk - 1) // nblk) * nblk  # multiple of nblk & cchunk
    while nblk * nxp > (1 << 31) - 1 and nblk > 256:
        nblk //= 2
        nxp = ((nx + nblk - 1) // nblk) * nblk
    cchunk = 2048 if nblk % 2048 == 0 else nblk
    pad = nxp - nx
    Sp = jnp.pad(S, ((0, pad), (0, 0))) if pad else jnp.asarray(S)
    D32p = jnp.pad(D32, ((0, pad), (0, 0))) if pad else D32
    effp = (
        jnp.pad(eff_j, (0, pad), constant_values=np.float32(np.inf))
        if pad else eff_j
    )

    # ---- pass 1: per-band thresholds ---------------------------------
    thr_parts = []
    for s in progress(
        range(0, nxp, nblk), "pair-budget pass 1", verbose
    ):
        Sb = jax.lax.dynamic_slice(Sp, (s, 0), (nblk, Sp.shape[1]))
        Db = jax.lax.dynamic_slice(D32p, (s, 0), (nblk, D32p.shape[1]))
        eb = jax.lax.dynamic_slice(effp, (s,), (nblk,))
        BINs = _band_bins_sym(
            D32p, Sp, Sb, Db, eb, effp, np.int32(s), inv_bin, nbins,
            cchunk, score,
        )
        thr_b = _band_thr_from_bins(
            BINs, jnp.int32(per_point_cap), bin_w, nbins
        )
        # barrier: bounds in-flight BINs state to one band's
        # (nblk, nxp) buffer
        jax.block_until_ready(thr_b)
        thr_parts.append(thr_b)
    thr = jnp.concatenate(thr_parts)  # (nxp,); pad rows are +inf

    # ---- pass 2: dense keep, counts as reductions, one extraction ----
    parts_i, parts_j = [], []
    m = 0
    P_cnt = jnp.zeros(nxp, dtype=jnp.int32)
    for s in progress(
        range(0, nxp, nblk), "pair-budget pass 2", verbose
    ):
        Sb = jax.lax.dynamic_slice(Sp, (s, 0), (nblk, Sp.shape[1]))
        Db = jax.lax.dynamic_slice(D32p, (s, 0), (nblk, D32p.shape[1]))
        eb = jax.lax.dynamic_slice(effp, (s,), (nblk,))
        keep, rowcnt, colcnt, kept = _band_keep2_dense(
            D32p, Sp, Sb, Db, eb, effp, thr, np.int32(s), cchunk,
            score,
        )
        rc_host = np.asarray(rowcnt)  # blocking: bounds in-flight state
        kept = int(rc_host.sum())
        P_cnt = _accum_band_counts(P_cnt, rowcnt, colcnt, np.int32(s))
        if kept == 0:
            continue
        # per-row top-k extraction beat the flatnonzero scatter when
        # last profiled (profile_budget_build.py); it needs K >= the max per-row
        # count, so fall back to flatnonzero when rows are so heavy the
        # top_k would scan most of the row anyway.  The extraction
        # sorts/scans a dense (rows, nxp) int panel — unlike the bins /
        # keep programs it cannot stream in column chunks, so split the
        # band into row slices bounding the sort input (the whole-band
        # top_k at nx=500k is a 17 GB allocation); slices concatenate
        # in row-major order, so the pair list is bit-identical to the
        # whole-band extraction
        # no row floor: past nxp ~ 2^20 a 256-row floor would let the
        # dense panel exceed the sort budget again (ADVICE r4)
        rows_per = max(1, min(nblk, _EXTRACT_ELEMS // max(nxp, 1)))
        for r0 in range(0, nblk, rows_per):
            r1 = min(r0 + rows_per, nblk)
            ksub = int(rc_host[r0:r1].sum())
            if ksub == 0:
                continue
            keep_sub = keep[r0:r1] if r1 - r0 < nblk else keep
            kcap = _cap_bucket(ksub)
            kmax = int(rc_host[r0:r1].max())
            K = min(max(1 << max(kmax - 1, 0).bit_length(), 128), nxp)
            if K <= nxp // 8:
                ki, kj = _extract_dense_topk(
                    keep_sub, np.int32(s + r0), K, kcap
                )
            else:
                ki, kj = _extract_dense(keep_sub, np.int32(s + r0), kcap)
            parts_i.append(ki[:ksub])
            parts_j.append(kj[:ksub])
        m += kept
    if parts_i:
        ij_i = jnp.concatenate(parts_i)
        ij_j = jnp.concatenate(parts_j)
    else:
        ij_i = jnp.zeros(0, jnp.int32)
        ij_j = jnp.zeros(0, jnp.int32)
    return (
        ij_i, ij_j, m, np.asarray(sid), np.asarray(S), eff,
        np.asarray(P_cnt)[:nx].astype(np.int32),
    )


@functools.partial(jax.jit, static_argnames=())
def _block_enemy_packed(
    S, S_block, y, y_block, effE_blk, effE, effO_blk, effO, row_off
):
    """Bit-packed mask of *new* enemy candidate pairs for a row block:
    differently-labelled, admitted by the enemy thresholds, and not
    already in the main candidate set (reference annchor.py:713-733,
    computed here blocked on device so no (nx, nx) host matrix ever
    materialises)."""
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    counts = jax.lax.dot_general(
        S_block, S,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    nx = counts.shape[1]
    enemy = y_block[:, None] != y[None, :]
    thrE = jnp.minimum(effE_blk[:, None], effE[None, :])
    thrO = jnp.minimum(effO_blk[:, None], effO[None, :])
    col_ids = jnp.arange(nx, dtype=jnp.int32)[None, :]
    row_ids = row_off + jnp.arange(
        counts.shape[0], dtype=jnp.int32
    )[:, None]
    keep = (
        enemy
        & (counts >= thrE)
        & ~(counts >= thrO)
        & (col_ids > row_ids)
    )
    B = keep.shape[0]
    bits = keep.reshape(B, nx // 32, 32).astype(jnp.uint32)
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits * weights[None, None, :], axis=2, dtype=jnp.uint32)


def enemy_candidate_pairs(S, y, eff_e, loc_eff, block: int = 4096):
    """New enemy candidate pairs (i < j), blocked on device.

    Returns int32 (m_new, 2).  Peak host memory is one decoded block,
    never an (nx, nx) matrix."""
    S = jnp.asarray(S)
    nx = S.shape[0]
    _, codes = np.unique(np.asarray(y), return_inverse=True)
    y_dev = jnp.asarray(codes.astype(np.int32))
    effE = jnp.asarray(np.asarray(eff_e, np.float32))
    effO = jnp.asarray(np.asarray(loc_eff, np.float32))

    pad_cols = (-nx) % 32
    S_pad = jnp.pad(S, ((0, pad_cols), (0, 0))) if pad_cols else S
    inf = np.float32(np.inf)
    y_padded = (
        jnp.pad(y_dev, (0, pad_cols), constant_values=-1)
        if pad_cols
        else y_dev
    )
    # padded columns: same label sentinel keeps them excluded via the
    # enemy test failing? no — -1 differs from every code, so exclude
    # them through an infinite enemy threshold instead
    effE_pad = (
        jnp.pad(effE, (0, pad_cols), constant_values=inf)
        if pad_cols
        else effE
    )
    effO_pad = (
        jnp.pad(effO, (0, pad_cols), constant_values=inf)
        if pad_cols
        else effO
    )

    nblk = min(block, nx)
    parts = []
    for s in range(0, nx, nblk):
        e = min(s + nblk, nx)
        Sb = S[s:e]
        yb = y_dev[s:e]
        eEb = effE[s:e]
        eOb = effO[s:e]
        if e - s < nblk:
            Sb = jnp.pad(Sb, ((0, nblk - (e - s)), (0, 0)))
            yb = jnp.pad(yb, (0, nblk - (e - s)), constant_values=-1)
            eEb = jnp.pad(eEb, (0, nblk - (e - s)), constant_values=inf)
            eOb = jnp.pad(eOb, (0, nblk - (e - s)), constant_values=inf)
        packed = np.asarray(
            _block_enemy_packed(
                S_pad, Sb, y_padded, yb, eEb, effE_pad, eOb, effO_pad,
                np.int32(s),
            )
        )[: e - s]
        r, c = _decode_packed(packed, nx, row_off=s)
        parts.append(np.stack([r, c], axis=1))
    return (
        np.concatenate(parts) if parts else np.zeros((0, 2), np.int32)
    )


@jax.jit
def _query_block_packed(SX, Sq_block, loc_thresh):
    """Bit-packed query-candidate mask for a block of queries:
    keep[q, j] = shared-anchor count >= loc_thresh.  uint32
    (B, nx/32) with bit b of word w = database column 32w+b."""
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    counts = jax.lax.dot_general(
        Sq_block,
        SX,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    B, nx = counts.shape
    keep = counts >= loc_thresh
    bits = keep.reshape(B, nx // 32, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * weights[None, None, :], axis=2, dtype=jnp.uint32)


def query_candidates(
    S_X, QD, locality: int, loc_thresh: int, block: int = 4096
):
    """Candidate database points for each query (reference
    get_query_locality, query_functions.py:18-37): counts of shared
    anchors between query q's nearest-anchor set and each database
    point's set; no adaptive threshold, no symmetrisation.

    Returns flat int64 arrays (db_ids, q_ids) — already in the padded
    pair layout the query pipeline consumes.  The per-block counts
    matrix stays on device; only the bit-packed keep mask crosses the
    link (nq*nx bits, e.g. 12.5 MB for 1000 queries against 100k
    points, vs 400 MB of f32 counts), decoded by the native
    single-pass decoder — same scheme as the fit's locality filter."""
    Sq, _ = anchor_membership(QD, locality)
    Sq = jnp.asarray(Sq)
    SX = jnp.asarray(S_X)
    nq = Sq.shape[0]
    nx = SX.shape[0]
    nx_pad = -(-nx // 32) * 32
    if nx_pad > nx:
        SX = jnp.pad(SX, ((0, nx_pad - nx), (0, 0)))
    parts_db, parts_q = [], []
    for s in range(0, nq, block):
        packed = np.asarray(
            _query_block_packed(
                SX, Sq[s : s + block], jnp.float32(loc_thresh)
            )
        )
        qs, dbs = _decode_packed(packed, nx, row_off=0)
        parts_q.append((qs.astype(np.int64) + s))
        parts_db.append(dbs.astype(np.int64))
    if not parts_db:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(parts_db), np.concatenate(parts_q)
