"""Post-fit graph-expansion refinement (exact-fit form of the
scout certify pass and the query path's graph-guided expansion).

Hosts the host-side orchestration: the metric evaluations run through
the fitted index's batched evaluator, everything else is flat-array
numpy over the (point, partner, distance) pool.  See
Annchor.refine_neighbor_graph for the public entry point.
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["refine_neighbor_graph"]

# device screen row-block: bounds the (rows, kk*kk) candidate panels
# (f32/int32) to ~60 MB each at kk=15 so the screen never competes
# with the resident fit state for HBM
_DEV_ROWS = 1 << 16

_dev_screen_cache = {}


def _get_dev_screen(q):
    """Jitted 2-hop screen + per-row top-q slate (cached per q).

    The device twin of the host screen below — same f32 arithmetic,
    same stable sort, so the returned slates are bit-identical to the
    host path (pinned by tests/test_scale_path.py).  Candidate
    generation, triangle screens and pool-membership all run as one
    fixed-shape program per row block; only the (rows, q) slates
    cross the link — the (rows, kk*kk) panels never leave the device.
    """
    fn = _dev_screen_cache.get(q)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp
    from functools import partial

    from annchor_tpu.ops.device_pipeline import _member_lex

    @partial(jax.jit, static_argnames=("q",), donate_argnums=())
    def screen(gi, gd, kth, si, sj, rows_idx, q):
        nx, kk = gi.shape
        gib = jnp.take(gi, rows_idx, axis=0)  # (R, kk)
        gdb = jnp.take(gd, rows_idx, axis=0)
        jj = jnp.where(gib >= 0, gib, 0)
        l = jnp.take(gi, jj.reshape(-1), axis=0).reshape(
            jj.shape[0], kk * kk
        )
        d_jl = jnp.take(gd, jj.reshape(-1), axis=0).reshape(
            jj.shape[0], kk * kk
        )
        d_ij = jnp.repeat(gdb, kk, axis=1)
        me = (rows_idx.astype(jnp.int32))[:, None]
        ok = (
            (jnp.repeat(gib, kk, axis=1) >= 0)
            & (l >= 0)
            & (l != me)
            & jnp.isfinite(d_jl)
        )
        lb = jnp.abs(d_ij - d_jl)
        ub = d_ij + d_jl
        lsafe = jnp.where(l >= 0, l, 0)
        adm = ok & (
            lb < jnp.maximum(kth[rows_idx][:, None], jnp.take(kth, lsafe))
        )
        qi = jnp.minimum(me, lsafe)
        qj = jnp.maximum(me, lsafe)
        inpool = _member_lex(
            si, sj, qi.reshape(-1), qj.reshape(-1)
        ).reshape(adm.shape)
        adm &= ~inpool
        ubm = jnp.where(adm, ub, jnp.inf)
        # top-q smallest by a PACKED key: the column index rides the
        # ub's low mantissa bits, so keys are unique per row and the
        # host twin (argpartition + sort over the same keys) selects
        # bit-identically — and lax.top_k replaces the full stable
        # row sort (the r5 200k re-measure put the sort-based screen
        # at ~110 s/round).  Positive f32 bitpatterns are monotone as
        # int32, so masking low bits keeps the ordering (coarser ub
        # ties broken by column, deterministically on both paths).
        cbits = max(1, (kk * kk - 1).bit_length())
        col = jnp.arange(kk * kk, dtype=jnp.int32)[None, :]
        mask = jnp.int32(-(1 << cbits))
        key = (
            jax.lax.bitcast_convert_type(ubm, jnp.int32) & mask
        ) | col
        negk, idx = jax.lax.top_k(-key, q)
        lq = jnp.take_along_axis(lsafe, idx, axis=1)
        ubq = jax.lax.bitcast_convert_type(
            (-negk) & mask, jnp.float32
        )
        return lq, ubq

    fn = screen
    _dev_screen_cache[q] = fn
    return fn


def _screen_blocks_dev(gi, gd, kth, pool_keys, nx, kk, q):
    """Run the 2-hop screen on device in _DEV_ROWS row blocks.

    Returns host (nx, q) slates (partner ids, triangle upper bounds)
    bit-identical to the host screen.  The tail block is padded with
    clipped row indices and trimmed after download, so every block
    compiles one program shape."""
    import jax.numpy as jnp

    screen = _get_dev_screen(q)
    # pad the pool to a bucketed length with lexicographically-max
    # sentinels (i = j = nx > every real query): the pool GROWS each
    # round as evals merge, and an unpadded shape recompiled the
    # screen every round.  The
    # binary search never lands on a sentinel for a real query, so
    # membership results are unchanged.
    m_pool = pool_keys.shape[0]
    m_pad = max(1 << 20, 1 << max(1, int(m_pool - 1).bit_length()))
    si_h = np.full(m_pad, nx, dtype=np.int32)
    sj_h = np.full(m_pad, nx, dtype=np.int32)
    si_h[:m_pool] = (pool_keys // nx).astype(np.int32)
    sj_h[:m_pool] = (pool_keys % nx).astype(np.int32)
    si = jnp.asarray(si_h)
    sj = jnp.asarray(sj_h)
    gid = jnp.asarray(np.asarray(gi, dtype=np.int32))
    gdd = jnp.asarray(np.asarray(gd, dtype=np.float32))
    kthd = jnp.asarray(np.asarray(kth, dtype=np.float32))
    outs = []
    rows = min(_DEV_ROWS, nx)
    for r0 in range(0, nx, rows):
        idx = np.minimum(
            np.arange(r0, r0 + rows, dtype=np.int32), nx - 1
        )
        outs.append(
            screen(gid, gdd, kthd, si, sj, jnp.asarray(idx), q)
        )
    import jax

    outs = jax.device_get(outs)
    lq = np.concatenate([o[0] for o in outs], axis=0)[:nx]
    ubq = np.concatenate([o[1] for o in outs], axis=0)[:nx]
    return lq, ubq


def refine_neighbor_graph(ann, rounds=2, budget=None):
    """Post-fit graph-expansion refinement: spend extra exact
    metric calls on the 2-hop neighbourhood of the fitted graph
    and re-rank.

    A true neighbour the candidate filter or pair budget discarded
    is almost always a graph-neighbour of a found one — the same
    expansion drives the scout certify pass (`_certify`) and the
    query path's graph-guided refinement; this is its exact-fit
    form.  First the reported-but-predicted edges are certified
    (exactly re-evaluated, cheapest wins first); then each round
    proposes (i, l) for every l in the row of every current
    neighbour j of i, screens by the triangle lower bound
    |d(i,j) - d(j,l)| against the rows' kth distances (a pair that
    cannot displace either endpoint's kth is never evaluated),
    then evaluates survivors under the budget in per-point fair
    shares ordered by the triangle upper bound d(i,j) + d(j,l)
    (provably-close first), and merges.

    budget: extra exact evaluations allowed.  Default: the
    unspent p_work allowance (int(p_work * N) - evals, floored at
    0) — so the default call never exceeds the fit's contract.
    Returns the refined (indices, distances) and updates
    ``ann.neighbor_graph`` and ``ann.evals``."""
    if ann.neighbor_graph is None:
        raise ValueError(
            "refine_neighbor_graph: fit() has not been run"
        )
    nx = ann.nx
    ngi, ngd = ann.neighbor_graph
    kk = ngi.shape[1] - 1  # columns past the self-prepend
    if budget is None:
        budget = max(0, int(ann.p_work * ann.N) - ann.evals)
    budget = int(budget)

    # per-round accounting (these counters separate pipeline cost —
    # batches, sorts — from device time): one dict per stage in
    # ann._refine_stats
    stats = []
    ann._refine_stats = stats

    def _exact(IJ):
        # always the exact metric, even after a hybrid fit (where
        # get_exact_ijs is still the scout): refinement certifies
        geq = (
            ann._exact_eval if ann._scouting else ann.get_exact_ijs
        )
        t0 = time.perf_counter()
        d = np.asarray(
            geq(ann.f, ann.X, IJ), dtype=np.float64
        )
        if stats:
            stats[-1]["eval_s"] = round(
                stats[-1].get("eval_s", 0.0)
                + (time.perf_counter() - t0), 3,
            )
            stats[-1]["eval_batches"] = (
                stats[-1].get("eval_batches", 0) + 1
            )
        ann.evals += d.shape[0]
        return d

    # exact store carried by a loaded v2 checkpoint (io.py): sorted
    # canonical (min*nx+max) keys with the fit's computed distances.
    # Candidates found here are free — no metric call, no budget.
    store_keys = getattr(ann, "_exact_keys", None)
    store_vals = getattr(ann, "_exact_vals", None)
    # Scout/certify hybrid fits land the ACTIVE evaluator's values in
    # the store (device_pipeline scatters the scout's approximations
    # for exploration pairs never certified into the final graph), so
    # a scouting ann's store is NOT a source of exact distances —
    # reusing it would mark approximate values pool_exact and skip
    # their certify budget (ADVICE r4).  Certified-exact stores only.
    have_store = (
        store_keys is not None
        and store_keys.size > 0
        and not getattr(ann, "_scouting", False)
    )

    def _store_lookup(keys):
        """(hit_mask, values-for-hits) for canonical pair keys."""
        pos = np.clip(
            np.searchsorted(store_keys, keys),
            0, store_keys.shape[0] - 1,
        )
        hit = store_keys[pos] == keys
        return hit, store_vals[pos[hit]]

    # canonical pair pool {min*nx+max: value} as sorted arrays
    rows0 = np.repeat(np.arange(nx, dtype=np.int64), kk)
    cols0 = ngi[:, 1:].reshape(-1).astype(np.int64)
    vals0 = ngd[:, 1:].reshape(-1).astype(np.float64)
    ngx = getattr(ann, "_ng_exact", None)
    if ngx is not None and ngx.shape == ngi.shape:
        flags0 = ngx[:, 1:].reshape(-1)
    else:  # unknown provenance (e.g. loaded index): treat exact
        flags0 = np.ones(rows0.shape[0], dtype=bool)
    ok = (cols0 >= 0) & (cols0 != rows0)
    keys = (
        np.minimum(rows0[ok], cols0[ok]) * nx
        + np.maximum(rows0[ok], cols0[ok])
    )
    order = np.lexsort((~flags0[ok], keys))
    keys_s = keys[order]
    first = np.ones(keys_s.shape[0], dtype=bool)
    first[1:] = keys_s[1:] != keys_s[:-1]
    pool_keys = keys_s[first]
    pool_vals = vals0[ok][order][first]
    # exact-wins dedupe: a pair reported from both endpoint rows
    # keeps its exact flag if either carries one
    pool_exact = flags0[ok][order][first]

    spent = 0
    stats.append({"stage": "certify", "t0": time.perf_counter()})
    todo = np.flatnonzero(~pool_exact)
    if todo.size and have_store:
        hit, vals = _store_lookup(pool_keys[todo])
        if hit.any():
            pool_vals[todo[hit]] = vals
            pool_exact[todo[hit]] = True
            stats[-1]["store_hits"] = int(hit.sum())
            todo = todo[~hit]
    if todo.size and budget > 0:
        # certify predicted reported edges, smallest first (they
        # sit highest in their rows' top-k lists)
        todo = todo[np.argsort(pool_vals[todo], kind="stable")]
        todo = todo[:budget]
        a = pool_keys[todo] // nx
        b = pool_keys[todo] % nx
        pool_vals[todo] = _exact(np.stack([a, b], axis=1))
        pool_exact[todo] = True
        spent += todo.shape[0]
    stats[-1]["evals"] = spent
    stats[-1]["wall_s"] = round(
        time.perf_counter() - stats[-1].pop("t0"), 3
    )

    def row_lists():
        a = pool_keys // nx
        b = pool_keys % nx
        pr = np.concatenate([a, b])
        pc = np.concatenate([b, a])
        pv = np.concatenate([pool_vals, pool_vals])
        px = np.concatenate([pool_exact, pool_exact])
        order = np.lexsort((pv, pr))
        pr_s = pr[order]
        starts = np.searchsorted(pr_s, np.arange(nx))
        rank = np.arange(pr_s.shape[0]) - starts[pr_s]
        sel = rank < kk
        gi = np.full((nx, kk), -1, dtype=np.int64)
        gd = np.full((nx, kk), np.inf)
        gx = np.ones((nx, kk), dtype=bool)
        gi[pr_s[sel], rank[sel]] = pc[order][sel]
        gd[pr_s[sel], rank[sel]] = pv[order][sel]
        gx[pr_s[sel], rank[sel]] = px[order][sel]
        return gi, gd, gx

    # The device screen twin exists and is bit-identical (pinned by
    # tests).  It lost to the host panels on the first accelerator
    # this ran on and has not been measured on a GPU yet, so the host
    # screen stays the default at every nx;
    # ANNCHOR_TPU_FORCE_DEVICE_EXPAND opts in (parity tests, or
    # hardware where gathers are cheap).
    use_dev = not os.environ.get(
        "ANNCHOR_TPU_DISABLE_DEVICE_EXPAND"
    ) and bool(os.environ.get("ANNCHOR_TPU_FORCE_DEVICE_EXPAND"))

    for r in range(int(rounds)):
        left = budget - spent
        if left <= 0:
            break
        share = left if r == rounds - 1 else max(
            1, left // (rounds - r)
        )
        stats.append({"stage": f"round{r}", "t0": time.perf_counter()})
        t_host = time.perf_counter()
        gi, gd, _ = row_lists()
        kth = gd[:, -1]
        q = int(
            min(
                kk * kk,
                max(kk, -(-2 * share // max(nx, 1)) + 2),
            )
        )
        # bucket to a multiple of 16: every round (and future runs)
        # shares one compiled screen program instead of recompiling
        # per share-derived width; extra slots are inf-padded and
        # filtered, so results only gain candidates when share
        # outruns the unbucketed width
        q = int(min(kk * kk, ((q + 15) // 16) * 16))
        # candidates: i -> j (with d_ij) -> l (with d_jl), held as
        # per-row (nx, kk*kk) matrices so the per-point fair-share
        # ranking is a row sort, NOT a global sort over all
        # nx*kk*kk candidates (a ~20x host-time difference at 100k).
        # On the scale path the whole screen runs on device in row
        # blocks (the r4 expansion wall was these panels as host
        # numpy passes: 64 of 74 s at 200k); both paths share the
        # same f32 arithmetic and stable sort, so the slates are
        # bit-identical (tests/test_scale_path.py pins this).
        me = np.arange(nx, dtype=np.int32)[:, None]
        if use_dev:
            t_dev = time.perf_counter()
            lq, ubq = _screen_blocks_dev(
                gi, gd, kth, pool_keys, nx, kk, q
            )
            stats[-1]["screen_dev_s"] = round(
                time.perf_counter() - t_dev, 3
            )
        else:
            gi32 = gi.astype(np.int32)
            gd32 = gd.astype(np.float32)
            kth32 = kth.astype(np.float32)
            jj = np.where(gi32 >= 0, gi32, 0)
            l = gi32[jj].reshape(nx, kk * kk)
            d_jl = gd32[jj].reshape(nx, kk * kk)
            d_ij = np.repeat(gd32, kk, axis=1)
            ok = (
                (np.repeat(gi32, kk, axis=1) >= 0)
                & (l >= 0)
                & (l != me)
                & np.isfinite(d_jl)
            )
            lb = np.abs(d_ij - d_jl)
            ub = d_ij + d_jl
            lsafe = np.where(l >= 0, l, 0)
            # displacement screen on either endpoint's kth; budget
            # priority = triangle *upper* bound (provably-close
            # first) within each point's slate — a global ub order
            # would let dense neighbourhoods starve the sparse rows
            # that need repair
            adm = ok & (lb < np.maximum(kth32[:, None], kth32[lsafe]))
            # drop already-pooled pairs up front so the q fair-share
            # slots hold only fresh candidates (the current graph
            # edges are the smallest-ub entries and would otherwise
            # fill every slate)
            ckey_m = (
                np.minimum(me, lsafe).astype(np.int64) * nx
                + np.maximum(me, lsafe)
            )
            pos_m = np.clip(
                np.searchsorted(pool_keys, ckey_m),
                0,
                max(pool_keys.shape[0] - 1, 0),
            )
            adm &= pool_keys[pos_m] != ckey_m
            ubm = np.where(adm, ub, np.inf).astype(np.float32)
            # packed-key selection, the device screen's twin: unique
            # keys make argpartition + sort bit-identical to top_k
            cbits = max(1, (kk * kk - 1).bit_length())
            colh = np.arange(kk * kk, dtype=np.int32)[None, :]
            maskh = np.int32(-(1 << cbits))
            keyh = (ubm.view(np.int32) & maskh) | colh
            part = np.argpartition(keyh, q - 1, axis=1)[:, :q]
            kq = np.take_along_axis(keyh, part, axis=1)
            o2 = np.argsort(kq, axis=1)
            idx2 = np.take_along_axis(part, o2, axis=1)
            lq = np.take_along_axis(lsafe, idx2, axis=1)
            ubq = (
                np.take_along_axis(kq, o2, axis=1) & maskh
            ).view(np.float32)
        keep2 = np.isfinite(ubq)
        src = np.broadcast_to(me, (nx, q))[keep2].astype(np.int64)
        rank = np.broadcast_to(
            np.arange(q, dtype=np.int64)[None, :], (nx, q)
        )[keep2]
        lf = lq[keep2].astype(np.int64)
        ub = ubq[keep2]
        ckey = np.minimum(src, lf) * nx + np.maximum(src, lf)
        # best (rank, ub) per candidate key wins the dedupe (the
        # remaining sorts run over <= nx*q entries, not nx*kk*kk)
        order = np.lexsort((ub, rank, ckey))
        ckey, ub, rank = ckey[order], ub[order], rank[order]
        fresh = np.ones(ckey.shape[0], dtype=bool)
        fresh[1:] = ckey[1:] != ckey[:-1]
        ckey, ub, rank = ckey[fresh], ub[fresh], rank[fresh]
        pos = np.searchsorted(pool_keys, ckey)
        pos = np.clip(pos, 0, max(pool_keys.shape[0] - 1, 0))
        new = (
            pool_keys[pos] != ckey
            if pool_keys.size
            else np.ones(ckey.shape[0], dtype=bool)
        )
        ckey, ub, rank = ckey[new], ub[new], rank[new]
        hits_merged = 0
        if have_store and ckey.size:
            # candidates the fit already evaluated merge for free
            hit, hvals = _store_lookup(ckey)
            if hit.any():
                hits_merged = int(hit.sum())
                pool_keys = np.concatenate([pool_keys, ckey[hit]])
                pool_vals = np.concatenate([pool_vals, hvals])
                pool_exact = np.concatenate(
                    [pool_exact, np.ones(hits_merged, dtype=bool)]
                )
                order_s = np.argsort(pool_keys, kind="stable")
                pool_keys = pool_keys[order_s]
                pool_vals = pool_vals[order_s]
                pool_exact = pool_exact[order_s]
                stats[-1]["store_hits"] = hits_merged
                ckey, ub, rank = ckey[~hit], ub[~hit], rank[~hit]
        if ckey.size == 0:
            stats[-1]["wall_s"] = round(
                time.perf_counter() - stats[-1].pop("t0"), 3
            )
            if hits_merged:
                continue  # the free merges changed the graph; keep going
            break
        if ckey.shape[0] > share:
            keep = np.lexsort((ub, rank))[:share]
            ckey = ckey[keep]
        a = ckey // nx
        b = ckey % nx
        stats[-1]["host_screen_s"] = round(
            time.perf_counter() - t_host, 3
        )
        stats[-1]["evals"] = int(ckey.shape[0])
        d = _exact(np.stack([a, b], axis=1))
        spent += ckey.shape[0]
        pool_keys = np.concatenate([pool_keys, ckey])
        pool_vals = np.concatenate([pool_vals, d])
        pool_exact = np.concatenate(
            [pool_exact, np.ones(ckey.shape[0], dtype=bool)]
        )
        order = np.argsort(pool_keys, kind="stable")
        pool_keys = pool_keys[order]
        pool_vals = pool_vals[order]
        pool_exact = pool_exact[order]
        stats[-1]["wall_s"] = round(
            time.perf_counter() - stats[-1].pop("t0"), 3
        )

    gi, gd, gx = row_lists()
    if getattr(ann, "verbose", False):
        for s in stats:
            print("    refine", s)
    ann.neighbor_graph = (
        np.concatenate([np.arange(nx)[:, None], gi], axis=1),
        np.concatenate([np.zeros((nx, 1)), gd], axis=1),
    )
    ann._ng_exact = np.concatenate(
        [np.ones((nx, 1), dtype=bool), gx], axis=1
    )
    return ann.neighbor_graph

