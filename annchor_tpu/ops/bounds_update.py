"""Bound tightening from computed distances ("pseudo-anchors").

Between refinement iterations, every already-computed exact distance
can tighten the triangle-inequality bounds of still-pending pairs: for
pair (i, j) and any point y with both d(i,y) and d(j,y) known,

    LB >= |d(i,y) - d(j,y)|      UB <= d(i,y) + d(j,y).

The reference walks per-point sorted lists with a two-pointer
intersection in numba and a 10 s wall-clock bailout (reference
annchor/annchor.py:475-512, utils.py:304-352).  The device formulation is
dense: scatter computed distances into an (nx, nc) matrix E with a
validity mask and reduce each pending pair's two gathered rows — pure
vector work, chunked over pairs.  For large nx the pseudo-anchor columns
are subsampled by computed-degree (any column subset still yields
valid bounds), keeping memory bounded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

F32_INF = np.float32(np.inf)


class _OneSlotDeviceCache:
    """Keeps the last pair array's device copy (holding the host array
    alive so identity stays valid across the fit iterations)."""

    def __init__(self):
        self._host = None
        self._dev = None

    def get(self, arr: np.ndarray):
        if self._host is not arr:
            self._host = arr
            self._dev = jnp.asarray(arr)
        return self._dev


_ij_cache = _OneSlotDeviceCache()


@functools.partial(jax.jit, static_argnames=("nx",))
def _build_E(IJ_dev, RA32, computed, nx: int):
    """Scatter computed distances into the dense pseudo-anchor matrix
    on device (the host used to build + upload ~20 MB per iteration;
    now only RA and the mask travel)."""
    ci = IJ_dev[:, 0]
    cj = IJ_dev[:, 1]
    d = jnp.where(computed, RA32, 0.0)
    E = jnp.zeros((nx, nx), dtype=jnp.float32)
    E = E.at[ci, cj].set(d, mode="drop")
    E = E.at[cj, ci].set(d, mode="drop")
    V = jnp.zeros((nx, nx), dtype=bool)
    V = V.at[ci, cj].set(computed, mode="drop")
    V = V.at[cj, ci].set(computed, mode="drop")
    return E, V


@jax.jit
def _tighten_chunk(E, V, I, J, lb_old, ub_old):
    Ei = jnp.take(E, I, axis=0)  # (b, nc)
    Ej = jnp.take(E, J, axis=0)
    both = jnp.take(V, I, axis=0) & jnp.take(V, J, axis=0)
    lb_new = jnp.max(
        jnp.where(both, jnp.abs(Ei - Ej), jnp.float32(-np.inf)), axis=1
    )
    ub_new = jnp.min(jnp.where(both, Ei + Ej, F32_INF), axis=1)
    return (
        jnp.maximum(lb_old, lb_new),
        jnp.minimum(ub_old, ub_new),
    )


def tighten_bounds(
    nx,
    IJs,
    RA,
    ncm,
    IJ_pending,
    lb_old,
    ub_old,
    max_cols: int = 16384,
    chunk: int = 65536,
):
    """Tighten (lb, ub) for the pending pairs using computed distances.

    IJs/RA/ncm: full pair state; IJ_pending: (p, 2) pairs to update.
    Returns tightened (lb, ub) float64 arrays of shape (p,).
    """
    IJs = np.asarray(IJs)
    if nx <= max_cols:
        # build E/V on device from the (cached) pair array — only RA
        # and the computed mask travel per call
        ij_dev = _ij_cache.get(IJs)
        Ed, Vd = _build_E(
            ij_dev,
            jnp.asarray(np.asarray(RA, dtype=np.float32)),
            jnp.asarray(~np.asarray(ncm)),
            int(nx),
        )
    else:
        computed = ~np.asarray(ncm)
        ci = IJs[computed, 0]
        cj = IJs[computed, 1]
        cd = np.asarray(RA, dtype=np.float32)[computed]
        # pseudo-anchor columns: highest computed-degree subset
        deg = np.bincount(ci, minlength=nx) + np.bincount(cj, minlength=nx)
        cols = np.argsort(-deg)[:max_cols]
        col_of = np.full(nx, -1, dtype=np.int64)
        col_of[cols] = np.arange(max_cols)
        nc = max_cols

        E = np.zeros((nx, nc), dtype=np.float32)
        V = np.zeros((nx, nc), dtype=bool)
        for a, b, d in ((ci, cj, cd), (cj, ci, cd)):
            cb = col_of[b]
            keep = cb >= 0
            E[a[keep], cb[keep]] = d[keep]
            V[a[keep], cb[keep]] = True
        Ed = jnp.asarray(E)
        Vd = jnp.asarray(V)
    p = IJ_pending.shape[0]
    lb_out = np.asarray(lb_old, dtype=np.float64).copy()
    ub_out = np.asarray(ub_old, dtype=np.float64).copy()
    # power-of-two chunk buckets: one compiled shape across fits
    nchunk = 4096
    while nchunk < p and nchunk < chunk:
        nchunk <<= 1
    for s in range(0, p, nchunk):
        e = min(s + nchunk, p)
        gi = IJ_pending[s:e, 0]
        gj = IJ_pending[s:e, 1]
        glb = np.asarray(lb_out[s:e], dtype=np.float32)
        gub = np.asarray(ub_out[s:e], dtype=np.float32)
        if e - s < nchunk:
            pad = nchunk - (e - s)
            gi = np.concatenate([gi, np.zeros(pad, gi.dtype)])
            gj = np.concatenate([gj, np.zeros(pad, gj.dtype)])
            glb = np.concatenate([glb, np.zeros(pad, np.float32)])
            gub = np.concatenate([gub, np.full(pad, np.inf, np.float32)])
        lb, ub = _tighten_chunk(
            Ed,
            Vd,
            jnp.asarray(gi),
            jnp.asarray(gj),
            jnp.asarray(glb),
            jnp.asarray(gub),
        )
        lb_out[s:e] = np.asarray(lb, dtype=np.float64)[: e - s]
        ub_out[s:e] = np.asarray(ub, dtype=np.float64)[: e - s]
    return lb_out, ub_out
