"""Entropic optimal transport (Sinkhorn) on the accelerator.

Exact EMD (reference: pynndescent's numba network simplex,
annchor/utils.py:82-86) is sequential pivoting and does not map to
matrix units; the device alternative offered here is log-domain Sinkhorn,
batched over pairs — hundreds of (nbins x nbins) logsumexp reductions
per step, all fused by XLA.  It converges to the entropy-regularised
transport cost: slightly *biased* vs exact EMD, hence registered with
``is_metric=False`` so the pipeline does not clip predictions to
triangle-inequality bounds (reference annchor.py:73-76, 368-372).

For exact values use the 'wasserstein' metric (native C++ host solver).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _sinkhorn_batch(A, B, C, eps, n_iter: int):
    """Batched log-domain Sinkhorn.

    A, B: (m, n) histograms (rows sum to 1, zeros allowed)
    C: (n, n) cost matrix;  eps: regularisation temperature.
    Returns (m,) transport costs <P, C>.
    """
    logA = jnp.log(jnp.where(A > 0, A, 1.0)) + jnp.where(A > 0, 0.0, -1e9)
    logB = jnp.log(jnp.where(B > 0, B, 1.0)) + jnp.where(B > 0, 0.0, -1e9)
    negC = -C[None, :, :] / eps  # (1, n, n)

    f = jnp.zeros_like(A)
    g = jnp.zeros_like(B)

    def body(_, fg):
        f, g = fg
        # f_i = eps*(logA_i - logsumexp_j(negC_ij + g_j/eps))
        f = eps * (
            logA
            - jax.scipy.special.logsumexp(
                negC + (g / eps)[:, None, :], axis=2
            )
        )
        g = eps * (
            logB
            - jax.scipy.special.logsumexp(
                negC + (f / eps)[:, :, None], axis=1
            )
        )
        return f, g

    f, g = jax.lax.fori_loop(0, n_iter, body, (f, g))
    logP = negC + (f / eps)[:, :, None] + (g / eps)[:, None, :]
    P = jnp.exp(logP)
    return jnp.sum(P * C[None, :, :], axis=(1, 2))


TINY = np.float32(1e-35)

# full f32 matvecs: the scout ranks candidates and TF32 (the GPU's
# default for f32 dots) drifts over hundreds of iterations
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _sinkhorn_exp_chunk(Xn, Zn, I, J, Kmat, KC, n_iter: int):
    """Exp-domain Sinkhorn for one id chunk, histograms gathered on
    device.  No transcendentals inside the loop — each iteration is two
    (B, n) @ (n, n) matvec batches, pure matrix-unit work (the
    log-domain variant pays ~n^2 exp() per pair per iteration and is
    far slower)."""
    A = jnp.take(Xn, I, axis=0)
    B = jnp.take(Zn, J, axis=0)

    def body(_, v):
        u = A / jnp.maximum(_mm(v, Kmat.T), TINY)
        return B / jnp.maximum(_mm(u, Kmat), TINY)

    v = jax.lax.fori_loop(0, n_iter, body, jnp.ones_like(B))
    u = A / jnp.maximum(_mm(v, Kmat.T), TINY)
    # <P, C> = sum_ij u_i K_ij C_ij v_j
    return jnp.sum(u * _mm(v, KC.T), axis=1)


@functools.partial(jax.jit, static_argnames=("na", "n_iter"))
def _sinkhorn_maxmin(Xn, Kmat, KC, first, na: int, n_iter: int):
    """Fused greedy max-min anchors on the scout metric: the whole
    anchors-times-columns loop as ONE device program (no host loop
    per anchor column).  Mirrors the
    reference quirk that the running min excludes the first anchor's
    column (reference pickers.py:48-50)."""
    n = Xn.shape[0]
    row_ids = jnp.arange(na, dtype=jnp.int32)
    Jall = jnp.arange(n, dtype=jnp.int32)

    def body(i, carry):
        D, A, ix = carry
        I = jnp.full((n,), ix, dtype=jnp.int32)
        col = _sinkhorn_exp_chunk(Xn, Xn, I, Jall, Kmat, KC, n_iter)
        D = jax.lax.dynamic_update_slice_in_dim(
            D, col[None, :], i, axis=0
        )
        A = A.at[i].set(ix)
        live = (row_ids >= 1) & (row_ids <= i)
        minD = jnp.min(
            jnp.where(live[:, None], D, jnp.float32(np.inf)), axis=0
        )
        nxt = jnp.where(i == 0, jnp.argmax(col), jnp.argmax(minD))
        return D, A, nxt.astype(jnp.int32)

    D0 = jnp.zeros((na, n), dtype=jnp.float32)
    A0 = jnp.zeros((na,), dtype=jnp.int32)
    D, A, _ = jax.lax.fori_loop(
        0, na, body, (D0, A0, jnp.asarray(first, jnp.int32))
    )
    return A, D


class SinkhornExpEngine:
    """Fast entropic-OT scout: batched exp-domain Sinkhorn with the
    dataset resident on device.

    Intended as the exploration metric of the scout/certify hybrid
    (see Annchor's `scout` handling): values carry an O(eps) bias and
    small violations of the triangle inequality, which the pipeline's
    is_metric=False path and the final exact certification absorb.
    eps is relative to max(cost_matrix); it must stay large enough
    that exp(-C/eps) is representable in float32 (C/eps < ~80).
    """

    def __init__(self, cost_matrix, eps: float = 0.015, n_iter: int = 300,
                 chunk: int = 8192):
        self.C = np.ascontiguousarray(cost_matrix, dtype=np.float32)
        self.eps = float(eps) * float(self.C.max())
        if self.C.max() / self.eps > 80:
            raise ValueError(
                "eps too small for the exp-domain kernel: need "
                "max(cost)/eps < 80, got %.1f" % (self.C.max() / self.eps)
            )
        self.n_iter = int(n_iter)
        self.chunk = int(chunk)
        K = np.exp(-self.C / self.eps)
        self._Kd = jnp.asarray(K)
        self._KCd = jnp.asarray(K * self.C)
        self._tables = {}

    def _table(self, X):
        # entries hold a strong ref to X so its id() cannot be recycled
        # for a different array while the entry is live
        key = id(X)
        hit = self._tables.get(key)
        if hit is None or hit[0] is not X:
            Xn = np.asarray(X, dtype=np.float32)
            s = Xn.sum(axis=1, keepdims=True)
            Xn = Xn / np.where(s > 0, s, 1.0)
            if len(self._tables) >= 2:  # dataset + query set at most
                self._tables.clear()
            hit = (X, jnp.asarray(Xn))
            self._tables[key] = hit
        return hit[1]

    def fused_maxmin(self, X, na, first_ix, verbose=False):
        """Whole greedy max-min anchor loop as one device program
        (scout-metric anchors for the hybrid fit)."""
        Xd = self._table(X)
        A, D = _sinkhorn_maxmin(
            Xd, self._Kd, self._KCd, int(first_ix), int(na), self.n_iter
        )
        return np.asarray(A), np.asarray(D, dtype=np.float64).T

    def batch_dev_ready(self, X):
        return True

    def batch_dev(self, X, I, J):
        """Device-id scout eval: I, J int32 device arrays -> device
        f32 values, no host hop (fused fit pipeline).  Chunked into
        bounded async dispatches; nothing blocks."""
        Xd = self._table(X)
        B = I.shape[0]
        if B <= self.chunk:
            return _sinkhorn_exp_chunk(
                Xd, Xd, I, J, self._Kd, self._KCd, self.n_iter
            )
        outs = [
            _sinkhorn_exp_chunk(
                Xd, Xd, I[s : s + self.chunk], J[s : s + self.chunk],
                self._Kd, self._KCd, self.n_iter,
            )
            for s in range(0, B, self.chunk)
        ]
        return jnp.concatenate(outs)

    def dispatch(self, X, Z, IJ):
        """Queue the whole batch as async device dispatches and return
        the (padded) device result + the true length.  No host sync:
        callers overlap host work (e.g. the exact-EMD certify pass)
        with the device compute and download once via np.asarray.

        Batch sizes are padded up to power-of-two buckets (>= 512,
        <= chunk) so repeated odd-sized calls — every certify round has
        a different candidate count — hit the compile cache instead of
        paying a fresh XLA compile per shape."""
        IJ = np.asarray(IJ, dtype=np.int64)
        m = IJ.shape[0]
        if m == 0:
            return None, 0
        if m >= self.chunk:
            pad = (-m) % self.chunk
        else:
            bucket = 512
            while bucket < m:
                bucket *= 2
            pad = bucket - m
        if pad:
            IJ = np.concatenate([IJ, IJ[-1:].repeat(pad, 0)])
        I = IJ[:, 0].astype(np.int32)
        J = IJ[:, 1].astype(np.int32)
        Xd = self._table(X)
        Zd = Xd if Z is X else self._table(Z)
        outs = [
            _sinkhorn_exp_chunk(
                Xd, Zd,
                jnp.asarray(I[s : s + self.chunk]),
                jnp.asarray(J[s : s + self.chunk]),
                self._Kd, self._KCd, self.n_iter,
            )
            for s in range(0, IJ.shape[0], self.chunk)
        ]
        dev = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
        return dev, m

    def __call__(self, X, Z, IJ):
        dev, m = self.dispatch(X, Z, IJ)
        if m == 0:
            return np.zeros(0, dtype=np.float64)
        # single blocking download for the whole batch: no per-chunk
        # sync between dispatches
        return np.asarray(dev, dtype=np.float64)[:m]


class SinkhornEngine:
    """Batched-pairs engine matching the Metric.batch contract."""

    def __init__(
        self,
        cost_matrix,
        eps: float = 0.02,
        n_iter: int = 200,
        chunk: int = 4096,
    ):
        self.C = np.ascontiguousarray(cost_matrix, dtype=np.float32)
        # scale eps relative to the cost magnitude
        self.eps = float(eps) * float(self.C.max())
        self.n_iter = int(n_iter)
        self.chunk = chunk

    def _normalise(self, X):
        X = np.asarray(X, dtype=np.float32)
        s = X.sum(axis=1, keepdims=True)
        s = np.where(s > 0, s, 1.0)
        return X / s

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        Xn = self._normalise(X)
        Zn = Xn if Z is X else self._normalise(Z)
        Cd = jnp.asarray(self.C)
        out = []
        for s in range(0, IJ.shape[0], self.chunk):
            blk = IJ[s : s + self.chunk]
            A = jnp.asarray(Xn[blk[:, 0]])
            B = jnp.asarray(Zn[blk[:, 1]])
            out.append(
                np.asarray(
                    _sinkhorn_batch(A, B, Cd, jnp.float32(self.eps), self.n_iter)
                )
            )
        return np.concatenate(out).astype(np.float64)
