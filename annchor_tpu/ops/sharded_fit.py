"""Multi-chip fit pipeline: DeviceFitState stage programs as SPMD
shard_map kernels over the 1-d ``pairs`` mesh axis.

SURVEY.md §2.2 prescribes the accelerator replacement for the
reference's joblib/numba single-node parallelism (reference
doc/parallelisation.rst:14-52): shard the candidate-pair axis over the
device mesh and combine per-point reductions with collectives.  This
module implements exactly that for the device-resident fit state
(ops/device_pipeline.py):

* per-pair state (lb/ub/dad/RA/ncm + pair endpoints) is sharded on its
  leading axis — each device holds m/s pairs resident in its memory, which is
  what lifts the single-chip memory wall on the 100k+ scale path;
* the point-incidence matrix P_idx is row-sharded (nx/s points per
  chip); per-point passes (k-th thresholds, guarantee marks, graph
  assembly) run on the owning chip against the gathered estimate
  vector, and per-point results are combined with all_gather/psum;
* scatters of exact distances at global pair ids become local-offset
  scatters (each id has exactly one owner; out-of-shard ids drop);
* the refinement selection is a chip-local top-k merged with a
  lexicographic (probability desc, pair id asc) sort, bit-identical to
  the single-chip ``lax.top_k`` (stable tie-break by index).

Both axes are padded to a multiple of the mesh size with sentinel
entries (pairs: RA=+inf, ncm=False; P_idx rows: id m_pad) that the
same ``id < m`` guards the single-chip kernels use exclude everywhere,
so a sharded fit computes the *same* graph as the single-chip fit
(pinned by tests/test_sharded_fit.py equality tests).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from annchor_tpu.parallel import PAIR_AXIS

F32_INF = np.float32(np.inf)


def _shard_bounds(axis_name, shard: int):
    d = jax.lax.axis_index(axis_name)
    return d * shard


def _local_ids(ids, start, shard: int):
    """Global ids -> local offsets; out-of-shard ids map to `shard`
    (out of bounds, dropped by mode='drop' scatters)."""
    loc = ids - start
    inb = (loc >= 0) & (loc < shard)
    return jnp.where(inb, loc, shard), inb


class ShardedFit:
    """Per-mesh factory/cache of the sharded stage programs.

    All jitted callables are cached per static-shape signature; the
    mesh and the pair/point shard sizes are fixed per instance.
    """

    def __init__(self, mesh, m_real: int, m_pad: int, nx: int, nx_pad: int):
        s = mesh.size
        assert m_pad % s == 0 and nx_pad % s == 0
        self.mesh = mesh
        self.s = s
        self.m_real = m_real
        self.m_pad = m_pad
        self.shard_m = m_pad // s
        self.nx = nx
        self.nx_pad = nx_pad
        self.shard_rows = nx_pad // s
        self._cache = {}

        from jax.sharding import NamedSharding, PartitionSpec as P

        self.P = P
        self.sh_pairs = NamedSharding(mesh, P(PAIR_AXIS))
        self.sh_repl = NamedSharding(mesh, P())

    # -- placement helpers --------------------------------------------------

    def put_pairs(self, arr, fill=0):
        """Pad a length-m_real device/host array to m_pad with `fill`
        and place it sharded over the pair axis."""
        arr = jnp.asarray(arr)
        if arr.shape[0] < self.m_pad:
            pad = jnp.full(
                (self.m_pad - arr.shape[0],), fill, dtype=arr.dtype
            )
            arr = jnp.concatenate([arr, pad])
        return jax.device_put(arr, self.sh_pairs)

    def put_rows(self, P_idx):
        """Pad an (nx, deg) matrix to nx_pad rows of sentinel m_pad and
        place it row-sharded."""
        P_idx = jnp.asarray(P_idx)
        if P_idx.shape[0] < self.nx_pad:
            pad = jnp.full(
                (self.nx_pad - P_idx.shape[0], P_idx.shape[1]),
                self.m_pad,
                dtype=P_idx.dtype,
            )
            P_idx = jnp.concatenate([P_idx, pad])
        return jax.device_put(P_idx, self.sh_pairs)

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

    def _get(self, key, builder):
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = builder()
        return fn

    # -- stage programs -----------------------------------------------------

    def sample_draw(self, dad, ncm, key, ilo, ihi, pool_n,
                    quotas: tuple, equal_mass: bool = False):
        """Stratified sample: every chip draws the identical sample
        from the gathered feature column (replicated compute — one
        local sort per chip instead of a distributed sort; sampling is
        O(m log m) flops on O(m) bytes, never the bottleneck)."""
        P = self.P

        def build():
            def body(dad, ncm, key, ilo, ihi, pool_n):
                from annchor_tpu.ops.device_pipeline import (
                    _sample_draw_body,
                )

                return _sample_draw_body(
                    dad, ncm, key, ilo, ihi, pool_n, quotas, equal_mass
                )

            return self._shmap(
                body, (P(),) * 6, (P(), P(), P())
            )

        fn = self._get(("sample", quotas, equal_mass), build)
        return fn(dad, ncm, key, ilo, ihi, pool_n)

    def build_pidx(self, ij_i, ij_j, lb, nx: int, max_deg: int,
                   capped: bool):
        """Incidence matrix: every chip runs the counting sort on the
        gathered pair list and keeps its own row block (replicated
        compute; the distributed-sort alternative is pathologically
        slow under GSPMD).  Output rows are padded to nx_pad with
        sentinel m_pad rows and sharded."""
        P = self.P
        rows_shard = self.shard_rows
        nx_pad = self.nx_pad
        m_pad = self.m_pad

        def build():
            def body(ij_i, ij_j, lb):
                from annchor_tpu.ops.device_pipeline import (
                    _pidx_from_pairs_body,
                    _pidx_from_pairs_capped_body,
                )

                if capped:
                    Pm = _pidx_from_pairs_capped_body(
                        ij_i, ij_j, lb, nx, max_deg
                    )
                else:
                    Pm = _pidx_from_pairs_body(ij_i, ij_j, nx, max_deg)
                if nx_pad > nx:
                    Pm = jnp.concatenate(
                        [
                            Pm,
                            jnp.full(
                                (nx_pad - nx, max_deg),
                                m_pad,
                                dtype=Pm.dtype,
                            ),
                        ]
                    )
                row0 = _shard_bounds(PAIR_AXIS, rows_shard)
                return jax.lax.dynamic_slice(
                    Pm, (row0, 0), (rows_shard, max_deg)
                )

            return self._shmap(
                body, (P(), P(), P()), P(PAIR_AXIS)
            )

        fn = self._get(("pidx", nx, max_deg, capped), build)
        return fn(ij_i, ij_j, lb)

    def features(self, D32, ij_i, ij_j, chunk: int):
        """LB/UB/dad per pair; dataset anchor columns replicated, pair
        endpoints sharded, chunked per chip like _features_init."""
        P = self.P

        def build():
            def body(D32, gi, gj):
                from annchor_tpu.ops.device_pipeline import (
                    _features_body,
                )

                return _features_body(D32, gi, gj, chunk)

            return self._shmap(
                body,
                (P(), P(PAIR_AXIS), P(PAIR_AXIS)),
                (P(PAIR_AXIS), P(PAIR_AXIS), P(PAIR_AXIS)),
            )

        return self._get(("features", chunk), build)(D32, ij_i, ij_j)

    def regress_update(
        self, lb, ub, dad, RA, ncm, inner, coefs, icepts, sids, sy,
        is_metric: bool, init: bool, n_bins: int,
    ):
        """Predict + clip every pair on its owning chip; land the
        sample exacts with local-offset scatters.  Sample predictions
        are replicated on host (`predict_sample_host`) so this program
        returns only sharded state and never blocks."""
        P = self.P
        shard = self.shard_m
        m_real = self.m_real

        def build():
            def body(lb, ub, dad, RA, ncm, inner, coefs, icepts, sids, sy):
                start = _shard_bounds(PAIR_AXIS, shard)
                labels = jnp.searchsorted(inner, dad, side="left")
                pred = jnp.zeros_like(dad)
                for b in range(n_bins):
                    pred_b = (
                        lb * coefs[b, 0]
                        + ub * coefs[b, 1]
                        + dad * coefs[b, 2]
                        + icepts[b]
                    )
                    pred = jnp.where(labels == b, pred_b, pred)
                loc, inb = _local_ids(sids, start, shard)
                if is_metric:
                    pred = jnp.clip(pred, lb, ub)
                ncm2 = ncm.at[loc].set(False, mode="drop")
                RA2 = pred if init else jnp.where(ncm2, pred, RA)
                RA2 = RA2.at[loc].set(
                    jnp.where(inb, sy, 0.0), mode="drop"
                )
                # sentinel pairs must keep RA=+inf: P_idx pad entries
                # read them as "worse than everything"
                gid = start + jnp.arange(shard, dtype=jnp.int32)
                RA2 = jnp.where(gid >= m_real, F32_INF, RA2)
                return RA2, ncm2

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body,
                (specs_p,) * 5 + (P(),) * 5,
                (specs_p, specs_p),
            )

        fn = self._get(("regress", is_metric, init, n_bins), build)
        return fn(lb, ub, dad, RA, ncm, inner, coefs, icepts, sids, sy)

    def scatter_exact(self, RA, ncm, ids, vals):
        P = self.P
        shard = self.shard_m

        def build():
            def body(RA, ncm, ids, vals):
                start = _shard_bounds(PAIR_AXIS, shard)
                loc, inb = _local_ids(ids, start, shard)
                RA2 = RA.at[loc].set(
                    jnp.where(inb, vals, 0.0), mode="drop"
                )
                ncm2 = ncm.at[loc].set(False, mode="drop")
                return RA2, ncm2

            return self._shmap(
                body,
                (P(PAIR_AXIS), P(PAIR_AXIS), P(), P()),
                (P(PAIR_AXIS), P(PAIR_AXIS)),
            )

        return self._get("scatter", build)(RA, ncm, ids, vals)

    def override_rows(self, RA, ids, vals):
        P = self.P
        shard = self.shard_m

        def build():
            def body(RA, ids, vals):
                start = _shard_bounds(PAIR_AXIS, shard)
                loc, inb = _local_ids(ids, start, shard)
                return RA.at[loc].set(
                    jnp.where(inb, vals, 0.0), mode="drop"
                )

            return self._shmap(
                body, (P(PAIR_AXIS), P(), P()), P(PAIR_AXIS)
            )

        return self._get("override", build)(RA, ids, vals)

    def gather_pairs(self, arrs, ids):
        """Values of sharded per-pair arrays at (replicated) global
        ids, via owner-contribution psum."""
        P = self.P
        shard = self.shard_m
        n = len(arrs)

        def build():
            def body(ids, *arrs):
                start = _shard_bounds(PAIR_AXIS, shard)
                loc, inb = _local_ids(ids, start, shard)
                locc = jnp.where(inb, loc, 0)
                return tuple(
                    jax.lax.psum(
                        jnp.where(
                            inb,
                            jnp.take(a, locc),
                            jnp.zeros((), a.dtype),
                        ),
                        PAIR_AXIS,
                    )
                    for a in arrs
                )

            return self._shmap(
                body,
                (P(),) + (P(PAIR_AXIS),) * n,
                (P(),) * n,
            )

        return self._get(("gather", n), build)(ids, *arrs)

    def select(
        self, RA, ncm, ij_i, ij_j, dad, P_idx,
        inner, cdf_grid, cdf_lo, cdf_inv, cdf_hi,
        nn: int, n_ref: int, guarantee: bool, nmin: int,
    ):
        """Sharded twin of device_pipeline._select.

        Per-point thresholds/guarantee marks on the owning chip (P_idx
        rows local, RA gathered), thresholds broadcast with all_gather,
        marks combined with psum, margin/probability scored on the
        pair-owning chip, and the global top-n_ref merged from local
        top-k's with a (prob desc, id asc) sort — identical tie-break
        to the single-chip lax.top_k."""
        P = self.P
        shard = self.shard_m
        rows_shard = self.shard_rows
        m_real = self.m_real
        m_pad = self.m_pad
        nx = self.nx
        max_deg = int(P_idx.shape[1])
        K, G = int(cdf_grid.shape[0]), int(cdf_grid.shape[1])
        kk = min(nn, max_deg - 1)
        k_loc = min(n_ref, shard)

        def build():
            def body(
                RA_full, ncm_full, ij_i, ij_j, dad, rows_blk,
                inner, cdf_grid, cdf_lo, cdf_inv, cdf_hi,
            ):
                start = _shard_bounds(PAIR_AXIS, shard)
                RA_pad = jnp.concatenate([RA_full, jnp.array([F32_INF])])
                ncm_ext = jnp.concatenate([ncm_full, jnp.array([False])])

                # --- per-point pass on my P_idx rows ------------------
                vals = jnp.take(RA_pad, rows_blk)
                valid = rows_blk < m_real
                vals = jnp.where(valid, vals, F32_INF)
                neg_topk, _ = jax.lax.top_k(-vals, kk + 1)
                thresh_loc = -neg_topk[:, kk]
                thresh = jax.lax.all_gather(
                    thresh_loc, PAIR_AXIS, tiled=True
                )  # (nx_pad,) replicated

                RAg_my = jax.lax.dynamic_slice(
                    RA_full, (start,), (shard,)
                )
                if guarantee:
                    ncm_rows = jnp.take(ncm_ext, rows_blk) & valid
                    todo_vals = jnp.where(ncm_rows, vals, F32_INF)
                    n_computed = jnp.sum((~ncm_rows) & valid, axis=1)
                    n_todo = jnp.clip(nmin - n_computed, 0, max_deg - 1)
                    svals = jnp.sort(todo_vals, axis=1)
                    kth = jnp.take_along_axis(
                        svals, n_todo[:, None], axis=1
                    )
                    mark_rows = (
                        (todo_vals < kth)
                        & ncm_rows
                        & (n_todo[:, None] > 0)
                    )
                    marks_loc = jnp.zeros(m_pad + 1, dtype=jnp.int32)
                    marks_loc = marks_loc.at[rows_blk.reshape(-1)].max(
                        mark_rows.reshape(-1).astype(jnp.int32),
                        mode="drop",
                    )
                    marks = jax.lax.psum(marks_loc, PAIR_AXIS)
                    marks_my = jax.lax.dynamic_slice(
                        marks, (start,), (shard,)
                    )
                    RAg_my = jnp.where(
                        marks_my > 0, jnp.float32(-1.0), RAg_my
                    )

                # --- per-pair pass on my pair shard -------------------
                ncm_my = jax.lax.dynamic_slice(
                    ncm_full, (start,), (shard,)
                )
                margin = (
                    jnp.maximum(
                        jnp.take(thresh, ij_i), jnp.take(thresh, ij_j)
                    )
                    - RAg_my
                )
                labels = jnp.clip(
                    jnp.searchsorted(inner, dad, side="right"), 0, K - 1
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
                prob = jnp.where(ncm_my, prob, jnp.float32(-1.0))

                v_loc, i_loc = jax.lax.top_k(prob, k_loc)
                gids = start + i_loc
                v_all = jax.lax.all_gather(v_loc, PAIR_AXIS, tiled=True)
                g_all = jax.lax.all_gather(gids, PAIR_AXIS, tiled=True)
                # stable global merge: prob desc, id asc (the
                # single-chip lax.top_k tie-break)
                _, _, chosen = jax.lax.sort(
                    (-v_all, g_all, g_all), num_keys=2
                )
                chosen = chosen[:n_ref]
                # pair coordinates via owner-contribution psum
                locs, inb = _local_ids(chosen, start, shard)
                locc = jnp.where(inb, locs, 0)
                sel_i = jax.lax.psum(
                    jnp.where(inb, jnp.take(ij_i, locc), 0), PAIR_AXIS
                )
                sel_j = jax.lax.psum(
                    jnp.where(inb, jnp.take(ij_j, locc), 0), PAIR_AXIS
                )
                return chosen, thresh[:nx], sel_i, sel_j

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body,
                (P(), P(), specs_p, specs_p, specs_p, specs_p)
                + (P(),) * 5,
                (P(), P(), P(), P()),
            )

        fn = self._get(
            ("select", max_deg, K, G, kk, k_loc, n_ref, guarantee, nmin),
            build,
        )
        return fn(
            RA, ncm, ij_i, ij_j, dad, P_idx,
            inner, cdf_grid, cdf_lo, cdf_inv, cdf_hi,
        )

    def knn(self, RA, ncm, P_idx, pair_sum, nn: int):
        """Sharded twin of device_pipeline._knn: each chip assembles
        the rows it owns; pair ids map to partner indices on device."""
        P = self.P
        rows_shard = self.shard_rows
        m_real = self.m_real
        nx = self.nx

        def build():
            def body(RA_full, ncm_full, rows_blk, pair_sum):
                row0 = _shard_bounds(PAIR_AXIS, rows_shard)
                RA_pad = jnp.concatenate([RA_full, jnp.array([F32_INF])])
                ncm_ext = jnp.concatenate([ncm_full, jnp.array([True])])
                vals = jnp.take(RA_pad, rows_blk)
                ncm_rows = jnp.take(ncm_ext, rows_blk)
                valid = rows_blk < m_real
                mx = jnp.max(
                    jnp.where(valid, vals, -F32_INF),
                    axis=1,
                    keepdims=True,
                )
                dpen = jnp.where(
                    valid, vals + jnp.where(ncm_rows, mx, 0.0), F32_INF
                )
                _, cols = jax.lax.top_k(-dpen, nn)
                ra_sel = jnp.take_along_axis(vals, cols, axis=1)
                sel_cm = ~jnp.take_along_axis(ncm_rows, cols, axis=1)
                pair_ids = jnp.take_along_axis(rows_blk, cols, axis=1)
                sums = jnp.take(
                    jnp.concatenate(
                        [pair_sum, jnp.zeros(1, pair_sum.dtype)]
                    ),
                    pair_ids,
                )
                gl_rows = row0 + jnp.arange(rows_shard, dtype=jnp.int32)
                partners = sums - gl_rows[:, None]
                partners = jnp.where(pair_ids < m_real, partners, -1)
                return pair_ids, partners, ra_sel, sel_cm

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body,
                (P(), P(), specs_p, P()),
                (specs_p, specs_p, specs_p, specs_p),
            )

        fn = self._get(("knn", nn), build)
        ids, partners, ra, sel_cm = fn(RA, ncm, P_idx, pair_sum)
        return ids[:nx], partners[:nx], ra[:nx], sel_cm[:nx]

    def enemy_refine(self, RA, ncm, P_idx, pair_sum, y, k: int):
        """Sharded twin of device_pipeline._enemy_refine_select: each
        chip selects the enemy refine candidates for the rows it
        owns."""
        P = self.P
        rows_shard = self.shard_rows
        m_real = self.m_real
        nx = self.nx
        # the unsharded twin clamps to the incidence width — top_k
        # fails outright when max_deg < k (narrow P_idx: small fits,
        # tight pair caps)
        k = min(int(k), int(P_idx.shape[1]))

        def build():
            def body(RA_full, ncm_full, rows_blk, pair_sum, y):
                from annchor_tpu.ops.device_pipeline import (
                    _enemy_refine_body,
                )

                row0 = _shard_bounds(PAIR_AXIS, rows_shard)
                RA_pad = jnp.concatenate([RA_full, jnp.array([F32_INF])])
                ncm_ext = jnp.concatenate([ncm_full, jnp.array([False])])
                ps_ext = jnp.concatenate(
                    [pair_sum, jnp.zeros(1, pair_sum.dtype)]
                )
                return _enemy_refine_body(
                    RA_pad, ncm_ext, rows_blk, ps_ext, y, row0, m_real, k
                )

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body, (P(), P(), specs_p, P(), P()), specs_p
            )

        fn = self._get(("enemy_refine", k), build)
        return fn(RA, ncm, P_idx, pair_sum, y)[:nx]

    def enemy_knn(self, RA, ncm, P_idx, pair_sum, y, nn: int):
        """Sharded twin of device_pipeline._enemy_knn."""
        P = self.P
        rows_shard = self.shard_rows
        m_real = self.m_real
        nx = self.nx

        def build():
            def body(RA_full, ncm_full, rows_blk, pair_sum, y):
                from annchor_tpu.ops.device_pipeline import (
                    _enemy_knn_body,
                )

                row0 = _shard_bounds(PAIR_AXIS, rows_shard)
                RA_pad = jnp.concatenate([RA_full, jnp.array([F32_INF])])
                ncm_ext = jnp.concatenate([ncm_full, jnp.array([True])])
                ps_ext = jnp.concatenate(
                    [pair_sum, jnp.zeros(1, pair_sum.dtype)]
                )
                return _enemy_knn_body(
                    RA_pad, ncm_ext, rows_blk, ps_ext, y, row0, m_real, nn
                )

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body,
                (P(), P(), specs_p, P(), P()),
                (specs_p, specs_p, specs_p),
            )

        fn = self._get(("enemy_knn", nn), build)
        ids, partners, ra = fn(RA, ncm, P_idx, pair_sum, y)
        return ids[:nx], partners[:nx], ra[:nx]

    def cover_incidence(self, dists, P_idx, pair_sum, slot, radii,
                        S: int):
        """Sharded twin of device_pipeline._cover_incidence (dists =
        where(ncm, ub, RA), computed by the caller)."""
        P = self.P
        rows_shard = self.shard_rows
        m_real = self.m_real
        nx = self.nx

        def build():
            def body(dists_full, rows_blk, pair_sum, slot, radii):
                from annchor_tpu.ops.device_pipeline import (
                    _cover_incidence_body,
                )

                row0 = _shard_bounds(PAIR_AXIS, rows_shard)
                d_pad = jnp.concatenate(
                    [dists_full, jnp.array([F32_INF])]
                )
                ps_ext = jnp.concatenate(
                    [pair_sum, jnp.zeros(1, pair_sum.dtype)]
                )
                return _cover_incidence_body(
                    d_pad, rows_blk, ps_ext, slot, radii, row0, m_real, S
                )

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body, (P(), specs_p, P(), P(), P()), specs_p
            )

        fn = self._get(("cover_inc", S), build)
        return fn(dists, P_idx, pair_sum, slot, radii)[:nx]

    def tighten_full(self, ij_i, ij_j, RA, ncm, lb, ub, nx: int,
                     block: int = 16):
        """Sharded tropical self-product: each chip scatters its
        computed pairs into a local (nx, nx) panel, panels combine with
        a psum, the min-plus/max-abs-diff product's *column blocks*
        split across the mesh (each chip reduces over its 1/s of the
        pseudo-anchor columns) and the per-entry accumulators combine
        with pmax/pmin; each chip then re-bounds its own pair shard."""
        P = self.P
        shard = self.shard_m
        m_real = self.m_real
        s = self.s
        # column blocks split evenly across chips
        nblk = (nx + block - 1) // block
        nblk_loc = -(-nblk // s)
        padn = nblk_loc * s * block

        def build():
            def body(ij_i, ij_j, RA, ncm, lb, ub):
                start = _shard_bounds(PAIR_AXIS, shard)
                gid = start + jnp.arange(shard, dtype=jnp.int32)
                ok = (~ncm) & (gid < m_real)
                d = jnp.where(ok, RA, jnp.float32(0))
                gi = jnp.where(ok, ij_i, nx)
                gj = jnp.where(ok, ij_j, nx)
                E = jnp.zeros((nx, nx), dtype=jnp.float32)
                E = E.at[gi, gj].set(d, mode="drop")
                E = E.at[gj, gi].set(d, mode="drop")
                V = jnp.zeros((nx, nx), dtype=jnp.float32)
                V = V.at[gi, gj].set(1.0, mode="drop")
                V = V.at[gj, gi].set(1.0, mode="drop")
                E = jax.lax.psum(E, PAIR_AXIS)
                V = jax.lax.psum(V, PAIR_AXIS) > 0
                Einf = jnp.where(V, E, F32_INF)
                Ezero = jnp.where(V, E, jnp.float32(0))
                if padn != nx:
                    Ezero = jnp.pad(Ezero, ((0, 0), (0, padn - nx)))
                    V = jnp.pad(V, ((0, 0), (0, padn - nx)))
                    Einf = jnp.pad(
                        Einf,
                        ((0, 0), (0, padn - nx)),
                        constant_values=F32_INF,
                    )

                dd = jax.lax.axis_index(PAIR_AXIS)

                def prod(t, acc):
                    lb_acc, ub_acc = acc
                    c0 = (dd * nblk_loc + t) * block
                    a = jax.lax.dynamic_slice(
                        Ezero, (0, c0), (nx, block)
                    )
                    v = jax.lax.dynamic_slice(V, (0, c0), (nx, block))
                    i = jax.lax.dynamic_slice(
                        Einf, (0, c0), (nx, block)
                    )
                    diff = jnp.abs(a[:, None, :] - a[None, :, :])
                    both = v[:, None, :] & v[None, :, :]
                    lb_acc = jnp.maximum(
                        lb_acc,
                        jnp.max(jnp.where(both, diff, 0.0), axis=2),
                    )
                    ub_acc = jnp.minimum(
                        ub_acc,
                        jnp.min(i[:, None, :] + i[None, :, :], axis=2),
                    )
                    return lb_acc, ub_acc

                lbM, ubM = jax.lax.fori_loop(
                    0,
                    nblk_loc,
                    prod,
                    (
                        jnp.zeros((nx, nx), dtype=jnp.float32),
                        jnp.full((nx, nx), F32_INF, dtype=jnp.float32),
                    ),
                )
                # combine the per-chip column-subset reductions
                lbM = jax.lax.pmax(lbM, PAIR_AXIS)
                ubM = jax.lax.pmin(ubM, PAIR_AXIS)
                gi2 = jnp.clip(ij_i, 0, nx - 1)
                gj2 = jnp.clip(ij_j, 0, nx - 1)
                lb_pair = lbM[gi2, gj2]
                ub_pair = ubM[gi2, gj2]
                lb2 = jnp.where(ncm, jnp.maximum(lb, lb_pair), lb)
                ub2 = jnp.where(ncm, jnp.minimum(ub, ub_pair), ub)
                return lb2, ub2

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body, (specs_p,) * 6, (specs_p, specs_p)
            )

        fn = self._get(("tighten_full", nx, block), build)
        return fn(ij_i, ij_j, RA, ncm, lb, ub)

    def tighten_cols(
        self, ij_i, ij_j, RA, ncm, lb, ub, thresh,
        ncol: int, cmax: int, chunk: int = 65536,
    ):
        """Sharded twin of _tighten_cols: pseudo-anchor panel built by
        psum of per-chip scatters, contender re-bounding chip-local."""
        P = self.P
        shard = self.shard_m
        m_real = self.m_real
        nx = self.nx
        cmax_loc = int(min(cmax, shard))
        chunk = int(min(chunk, cmax_loc))

        def build():
            def body(ij_i, ij_j, RA, ncm, lb, ub, thresh):
                start = _shard_bounds(PAIR_AXIS, shard)
                gid = start + jnp.arange(shard, dtype=jnp.int32)
                real = gid < m_real
                okv = (~ncm) & real
                w = okv.astype(jnp.int32)
                deg = jnp.zeros(nx, dtype=jnp.int32)
                deg = deg.at[ij_i].add(w, mode="drop")
                deg = deg.at[ij_j].add(w, mode="drop")
                deg = jax.lax.psum(deg, PAIR_AXIS)
                _, cols_ids = jax.lax.top_k(deg, ncol)
                col_of = jnp.full(nx, -1, dtype=jnp.int32).at[
                    cols_ids
                ].set(jnp.arange(ncol, dtype=jnp.int32))

                ci = jnp.take(col_of, jnp.clip(ij_i, 0, nx - 1))
                cj = jnp.take(col_of, jnp.clip(ij_j, 0, nx - 1))
                ci = jnp.where(okv & (ci >= 0), ci, ncol)
                cj = jnp.where(okv & (cj >= 0), cj, ncol)
                E = jnp.zeros((nx, ncol), dtype=jnp.float32)
                V = jnp.zeros((nx, ncol), dtype=jnp.float32)
                E = E.at[ij_j, ci].set(RA, mode="drop")
                E = E.at[ij_i, cj].set(RA, mode="drop")
                V = V.at[ij_j, ci].set(1.0, mode="drop")
                V = V.at[ij_i, cj].set(1.0, mode="drop")
                E = jax.lax.psum(E, PAIR_AXIS)
                V = jax.lax.psum(V, PAIR_AXIS) > 0
                # validity folded into the panel as +inf entries: the
                # chunk loop then gathers one f32 panel instead of
                # panel + mask (bit-identical bounds)
                E = jnp.where(V, E, F32_INF)

                cap = jnp.maximum(
                    jnp.take(thresh, jnp.clip(ij_i, 0, nx - 1)),
                    jnp.take(thresh, jnp.clip(ij_j, 0, nx - 1)),
                )
                cont = ncm & real & (lb < cap)
                ids = jnp.nonzero(cont, size=cmax_loc, fill_value=shard)[
                    0
                ].astype(jnp.int32)

                iip = jnp.concatenate([ij_i, jnp.zeros(1, ij_i.dtype)])
                jjp = jnp.concatenate([ij_j, jnp.zeros(1, ij_j.dtype)])
                lbp = jnp.concatenate([lb, jnp.zeros(1, lb.dtype)])
                ubp = jnp.concatenate(
                    [ub, jnp.full(1, F32_INF, ub.dtype)]
                )
                nchunks = (cmax_loc + chunk - 1) // chunk
                ids = jnp.pad(
                    ids, (0, nchunks * chunk - cmax_loc),
                    constant_values=shard,
                )

                def cbody(t, state):
                    lb_acc, ub_acc = state
                    sel = jax.lax.dynamic_slice(
                        ids, (t * chunk,), (chunk,)
                    )
                    gi = jnp.take(iip, sel)
                    gj = jnp.take(jjp, sel)
                    Ei = jnp.take(E, jnp.clip(gi, 0, nx - 1), axis=0)
                    Ej = jnp.take(E, jnp.clip(gj, 0, nx - 1), axis=0)
                    both = (Ei < F32_INF) & (Ej < F32_INF)
                    lb_new = jnp.max(
                        jnp.where(both, jnp.abs(Ei - Ej), 0.0), axis=1
                    )
                    ub_new = jnp.min(Ei + Ej, axis=1)
                    lb_acc = lb_acc.at[sel].max(lb_new, mode="drop")
                    ub_acc = ub_acc.at[sel].min(ub_new, mode="drop")
                    return lb_acc, ub_acc

                lb2, ub2 = jax.lax.fori_loop(
                    0, nchunks, cbody, (lbp, ubp)
                )
                return lb2[:shard], ub2[:shard]

            specs_p = P(PAIR_AXIS)
            return self._shmap(
                body,
                (specs_p,) * 6 + (P(),),
                (specs_p, specs_p),
            )

        fn = self._get(("tighten_cols", ncol, cmax_loc, chunk), build)
        return fn(ij_i, ij_j, RA, ncm, lb, ub, thresh)

    def clip_ra(self, RA, ncm, lb, ub):
        P = self.P

        def build():
            def body(RA, ncm, lb, ub):
                return jnp.where(ncm, jnp.clip(RA, lb, ub), RA)

            specs_p = P(PAIR_AXIS)
            return self._shmap(body, (specs_p,) * 4, specs_p)

        return self._get("clip", build)(RA, ncm, lb, ub)
