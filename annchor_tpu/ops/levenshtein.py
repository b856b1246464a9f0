"""Batched Levenshtein (edit-distance) row-DP kernels.

The reference implementation evaluates edit distance one pair at a time
through the python-Levenshtein C extension fanned out over joblib worker
processes (reference: annchor/distances.py:16-20, annchor/utils.py:152-177).
Here the same workload is re-designed as a *batched* dynamic-programming
kernel: many pairs are evaluated simultaneously, with the classic row
recurrence

    D[i, j] = min(D[i-1, j] + 1, D[i, j-1] + 1, D[i-1, j-1] + cost_ij)

vectorised across both the pair axis and the column axis.  The
within-row dependency (``D[i, j-1] + 1``) is resolved with a prefix
minimum:

    t_j   = min(D[i-1, j] + 1, D[i-1, j-1] + cost_ij)   (t_0 = i)
    D[i,j] = j + cummin_{k<=j}(t_k - k)

which is exact (induction on j) and turns every DP row into pure
vector ops + one ``lax.cummin``.  The row loop
runs only to the longest *shorter* string in the batch (pairs are
swapped so rows always walk the shorter string), so length-bucketing
the pair list directly reduces work.

The bit-parallel Myers kernels (``levenshtein_myers.py``) replace
this tier whenever the alphabet is small enough; this one serves huge
alphabets.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from annchor_tpu.ops._backend import round_up

INT32_INF = np.int32(2**30)


def _cummin_log(x):
    """Prefix minimum along axis 1 via a log-shift (Hillis–Steele)
    scan: ceil(log2(n)) shifted elementwise mins.

    Mathematically identical to ``lax.cummin``, whose generic scan
    lowering was pathological to compile for wide rows.
    """
    n = x.shape[1]
    k = 1
    while k < n:
        shifted = jnp.pad(
            x[:, :-k], ((0, 0), (k, 0)), constant_values=INT32_INF
        )
        x = jnp.minimum(x, shifted)
        k *= 2
    return x


def encode_strings(strings, pad_to_multiple: int = 128):
    """Encode a sequence of unicode strings to a padded codepoint matrix.

    Returns
    -------
    codes: np.ndarray int32, shape (n, L)
        Unicode codepoints, padded with -1.  L is the maximum string
        length rounded up to ``pad_to_multiple`` (bounds compiled shapes).
    lengths: np.ndarray int32, shape (n,)
    """
    n = len(strings)
    lengths = np.array([len(s) for s in strings], dtype=np.int32)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    codes = np.full((n, L), -1, dtype=np.int32)
    for k, s in enumerate(strings):
        if len(s):
            codes[k, : len(s)] = np.frombuffer(
                s.encode("utf-32-le"), dtype=np.uint32
            ).astype(np.int32)
    return codes, lengths


def encode_sequences(seqs, pad_to_multiple: int = 128):
    """Encode arbitrary integer sequences (lists/arrays) like strings."""
    n = len(seqs)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    codes = np.full((n, L), -1, dtype=np.int32)
    for k, s in enumerate(seqs):
        codes[k, : len(s)] = np.asarray(s, dtype=np.int32)
    return codes, lengths


@functools.partial(jax.jit, static_argnames=("unroll",))
def _lev_batch(a, b, la, lb, unroll: int = 1):
    """Edit distance for a batch of pre-gathered pairs.

    a, b: int32 (B, L) codepoints padded with -1
    la, lb: int32 (B,) true lengths; requires la[i] <= lb[i] is NOT
        assumed — the caller should pre-swap so rows walk the shorter
        string, but correctness holds either way.
    Returns int32 (B,).
    """
    B, L = a.shape
    cols = jnp.arange(L + 1, dtype=jnp.int32)

    row0 = jnp.broadcast_to(cols, (B, L + 1))
    # result for la == 0 rows is lb
    result0 = lb.astype(jnp.int32)

    max_rows = jnp.max(la)

    def body(i, carry):
        prev, result = carry
        ca = jax.lax.dynamic_slice_in_dim(a, i - 1, 1, axis=1)  # (B,1)
        cost = (ca != b).astype(jnp.int32)  # (B, L)
        t = jnp.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        t_full = jnp.concatenate(
            [jnp.full((B, 1), i, dtype=jnp.int32), t], axis=1
        )
        new_row = _cummin_log(t_full - cols) + cols
        res_i = jnp.take_along_axis(new_row, lb[:, None], axis=1)[:, 0]
        result = jnp.where(i == la, res_i, result)
        return new_row, result

    _, result = jax.lax.fori_loop(
        1, max_rows + 1, body, (row0, result0), unroll=unroll
    )
    return result


def levenshtein_pairs(
    codes,
    lengths,
    I,
    J,
    block_size: int = 8192,
    sort_by_length: bool = True,
    backend_fn=None,
):
    """Edit distances for pairs (I[k], J[k]) of pre-encoded strings.

    Replaces the reference's per-pair C-extension calls
    (annchor/utils.py:144-150) with chunked batched device evaluation.
    Pairs are sorted by the length of their shorter member so each
    chunk's dynamic row loop terminates as early as possible.

    codes: np.ndarray/jax int32 (n, L);  lengths: (n,) int32
    I, J: int arrays (m,)
    backend_fn: kernel taking (a, b, la, lb) -> dists; defaults to the
        XLA formulation.  The Pallas kernel plugs in here.
    Returns np.ndarray int32 (m,).
    """
    fn = backend_fn if backend_fn is not None else _lev_batch
    I = np.asarray(I, dtype=np.int64)
    J = np.asarray(J, dtype=np.int64)
    m = I.shape[0]
    if m == 0:
        return np.zeros(0, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)

    la = lengths[I]
    lb = lengths[J]
    # rows walk the shorter string
    swap = la > lb
    I2 = np.where(swap, J, I)
    J2 = np.where(swap, I, J)
    la, lb = np.minimum(la, lb), np.maximum(la, lb)

    if sort_by_length and m > block_size:
        order = np.argsort(la, kind="stable")
    else:
        order = np.arange(m)

    out = np.zeros(m, dtype=np.int32)
    codes = jnp.asarray(codes)
    for s in range(0, m, block_size):
        sel = order[s : s + block_size]
        bsz = sel.shape[0]
        if bsz < block_size:  # pad to the static block shape
            pad = np.zeros(block_size - bsz, dtype=np.int64)
            gi = np.concatenate([I2[sel], pad])
            gj = np.concatenate([J2[sel], pad])
            gla = np.concatenate([la[sel], np.zeros_like(pad, np.int32)])
            glb = np.concatenate([lb[sel], np.zeros_like(pad, np.int32)])
        else:
            gi, gj, gla, glb = I2[sel], J2[sel], la[sel], lb[sel]
        a = jnp.take(codes, jnp.asarray(gi), axis=0)
        b = jnp.take(codes, jnp.asarray(gj), axis=0)
        d = fn(a, b, jnp.asarray(gla), jnp.asarray(glb))
        out[sel] = np.asarray(d)[:bsz]
    return out


def levenshtein_scalar(x: str, y: str) -> int:
    """Host scalar edit distance (oracle / fallback for tiny calls)."""
    try:
        import Levenshtein as _lev

        return _lev.distance(x, y)
    except ImportError:
        pass
    la, lb = len(x), len(y)
    if la == 0:
        return lb
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (x[i - 1] != y[j - 1]),
            )
        prev = cur
    return prev[lb]
