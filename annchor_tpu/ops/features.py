"""Anchor-geometry feature kernels.

Replaces the reference's numba kernels `get_bounds_njit_ijs`
(annchor/utils.py:274-301), `get_dad_ijs` (annchor/utils.py:355-380)
and their query-side variants (annchor/query_functions.py:70-129) with
fused, vectorised gather+reduce ops that XLA compiles for the device.
Per-pair work is O(n_anchors) and fully data-parallel, so this is pure
jit/vmap — no Pallas needed (SURVEY.md §7 step 2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _bounds_dad_kernel(D, DJ, I, J, cA_rows, cA_cols):
    """Fused LB/UB/dad for pairs (I into D, J into DJ).

    D: (nx, na) float32 anchor distances for the left side
    DJ: (ny, na) for the right side (same array for in-sample pairs)
    cA_rows/cA_cols: (nx,)/(ny,) argmin anchor per point.
    Returns (m,) lb, ub, dad.
    """
    Di = jnp.take(D, I, axis=0)  # (m, na)
    Dj = jnp.take(DJ, J, axis=0)
    lb = jnp.max(jnp.abs(Di - Dj), axis=1)
    ub = jnp.min(Di + Dj, axis=1)
    # double anchor distance: (D[i, cA[j]] + D[j, cA[i]]) / 2
    cj = jnp.take(cA_cols, J)  # closest anchor of j
    ci = jnp.take(cA_rows, I)
    dad = (
        jnp.take_along_axis(Di, cj[:, None], axis=1)[:, 0]
        + jnp.take_along_axis(Dj, ci[:, None], axis=1)[:, 0]
    ) * 0.5
    return lb, ub, dad


def bounds_and_dad(D, I, J, DJ=None, chunk: int = 1 << 20):
    """Triangle-inequality bounds + double-anchor-distance features.

    D: np/jax (nx, na); I, J: int arrays (m,).  DJ: optional right-side
    anchor-distance matrix for query pairs (reference
    query_functions.py:102-129); defaults to D (in-sample).
    Returns np.float64 arrays (lb, ub, dad) of shape (m,).
    """
    D32 = jnp.asarray(D, dtype=jnp.float32)
    DJ32 = D32 if DJ is None else jnp.asarray(DJ, dtype=jnp.float32)
    cA_rows = jnp.argmin(D32, axis=1)
    cA_cols = cA_rows if DJ is None else jnp.argmin(DJ32, axis=1)
    I = np.asarray(I, dtype=np.int32)
    J = np.asarray(J, dtype=np.int32)
    m = I.shape[0]
    if m == 0:
        z = np.zeros(0, dtype=np.float64)
        return z, z.copy(), z.copy()
    # power-of-two chunk buckets: compiled shapes are shared across
    # differing pair counts (and across fits)
    nchunk = 4096
    while nchunk < m and nchunk < chunk:
        nchunk <<= 1
    lbs, ubs, dads = [], [], []
    for s in range(0, m, nchunk):
        e = min(s + nchunk, m)
        gi, gj = I[s:e], J[s:e]
        if e - s < nchunk:  # uniform chunk shape: one compile
            pad = nchunk - (e - s)
            gi = np.concatenate([gi, np.zeros(pad, np.int32)])
            gj = np.concatenate([gj, np.zeros(pad, np.int32)])
        lb, ub, dad = _bounds_dad_kernel(
            D32, DJ32, jnp.asarray(gi), jnp.asarray(gj), cA_rows, cA_cols
        )
        lbs.append(np.asarray(lb)[: e - s])
        ubs.append(np.asarray(ub)[: e - s])
        dads.append(np.asarray(dad)[: e - s])
    return (
        np.concatenate(lbs).astype(np.float64),
        np.concatenate(ubs).astype(np.float64),
        np.concatenate(dads).astype(np.float64),
    )


@functools.partial(jax.jit, static_argnames=("locality",))
def anchor_membership(D, locality: int):
    """Binary membership S[i, a] = 1 iff anchor a is among point i's
    `locality` nearest anchors (reference annchor.py:235-241 builds the
    transposed Amatrix with a Python loop)."""
    D = jnp.asarray(D, dtype=jnp.float32)
    nx, na = D.shape
    # tiny datasets can have fewer anchors than `locality`; top_k
    # refuses k > na outright, and "all anchors are near" is the
    # right degenerate semantics
    locality = min(int(locality), int(na))
    _, sid = jax.lax.top_k(-D, locality)  # (nx, locality) nearest anchors
    S = jnp.zeros((nx, na), dtype=jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(nx)[:, None], sid.shape)
    S = S.at[rows, sid].set(1.0)
    return S, sid


@jax.jit
def shared_anchor_counts(S, S_other=None):
    """counts[i, j] = number of shared near-anchors — a binary matmul
    on the matrix units (replaces the nx× masked-sum loop in reference
    utils.py:469-471)."""
    St = S if S_other is None else S_other
    # 0/1 operands, f32 sums: exact at default (TF32) precision
    return jax.lax.dot_general(
        S,
        St,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
