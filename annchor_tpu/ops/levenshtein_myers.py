"""Bit-parallel (Myers) batched Levenshtein distance in XLA.

The row-DP formulation in ``levenshtein.py`` spends one vector lane per DP
cell.  Myers' bit-vector algorithm (Myers 1999, Hyyrö's edit-distance
variant) packs 32 DP cells into each uint32 lane: the vertical delta
column of the DP matrix is represented by two bit-vectors (VP/VN) and
each text character updates them with ~15 word-parallel bitwise ops,
so per text character the work drops from O(L) lanes to O(L/32) words
— a ~16-25x kernel speedup at ~600-char strings.

Multi-word mechanics (all on (B, W) uint32 tensors, B = pair batch,
W = ceil(pattern_len/32) words):

* the addition ``(Eq & VP) + VP`` needs carries across words — done
  with a Kogge–Stone (generate, propagate) prefix scan over the word
  axis, log2(W) steps;
* the shifts ``HP << 1`` / ``HN << 1`` carry the MSB of word w into
  the LSB of word w+1 (and shift a boundary 1 into HP's LSB, which is
  what makes this the *distance* variant: column 0 of the DP is j);
* per-pair pattern lengths differ, so the score tap (bit m-1) is a
  per-pair word gather + mask test.

Strings are pre-encoded against a dataset-wide dense alphabet; each
string's Peq bitmask table (alphabet x W words) is precomputed once.
Huge alphabets use the row-DP kernel instead (reference workloads:
ACGT/a-z, so Peq stays a few MB).

These kernels are plain ``jax.numpy``/``lax``.  They carry the anchor
and exact-row columns, and they are the oracle for the GPU pair kernel
in ``levenshtein_triton.py``, which serves pair batches on the GPU at
the widths where it measured faster (``levenshtein_triton.serves``).

Replaces the python-Levenshtein C extension hot loop of the reference
(reference annchor/distances.py:16-20, annchor/utils.py:144-177).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

UINT1 = np.uint32(1)
UFULL = np.uint32(0xFFFFFFFF)

# beyond this many distinct symbols the Peq table stops paying for
# itself; callers fall back to the row-DP kernel
MAX_ALPHABET = 192


def encode_alphabet(codes: np.ndarray, lengths: np.ndarray):
    """Map a padded codepoint matrix (pad = -1) to dense alphabet ids.

    Returns (ids int32 (n, L) with -1 pads, alphabet_size) or None when
    the alphabet is too large for the bit-parallel path.
    """
    codes = np.asarray(codes)
    uniq = np.unique(codes)
    uniq = uniq[uniq >= 0]
    if uniq.shape[0] > MAX_ALPHABET:
        return None
    lut_size = int(uniq.max()) + 1 if uniq.shape[0] else 1
    if lut_size > (1 << 22):  # degenerate sparse codepoints: use search
        ids = np.searchsorted(uniq, np.where(codes < 0, uniq[0], codes))
        ids = np.where(codes < 0, -1, ids).astype(np.int32)
        return ids, int(uniq.shape[0])
    lut = np.full(lut_size + 1, -1, dtype=np.int32)
    lut[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
    ids = np.where(codes < 0, -1, lut[np.clip(codes, 0, lut_size)])
    return ids.astype(np.int32), int(uniq.shape[0])


def build_planes(peq: np.ndarray, alphabet: int):
    """Bitplane decomposition of the Peq tables.

    Selecting Eq = peq[s, c] by a per-pair symbol c is a per-lane
    gather.  Writing c in binary, position p matches c
    iff every bit of the pattern symbol at p equals the corresponding
    bit of c, so with

        P[k][1] = OR of peq[:, c] over symbols with bit k set
        P[k][0] = OR over symbols with bit k clear

    the exact mask is  Eq = AND_k P[k][bit_k(c)]  — K selects + K-1
    ANDs instead of an alphabet-way gather (K = ceil(log2(alphabet))).

    Returns uint32 (K, 2, n, W).
    """
    n, _, W = peq.shape
    K = max(int(np.ceil(np.log2(max(alphabet, 2)))), 1)
    planes = np.zeros((K, 2, n, W), dtype=np.uint32)
    for c in range(alphabet):
        for k in range(K):
            planes[k, (c >> k) & 1] |= peq[:, c, :]
    return planes


def build_peq(ids: np.ndarray, lengths: np.ndarray, alphabet: int):
    """Per-string Peq bitmask tables.

    ids: (n, L) dense alphabet ids (-1 pad).  Returns uint32
    (n, alphabet, W) with W = ceil(L/32); bit k of word w of Peq[s, c]
    is set iff ids[s, 32w + k] == c.
    """
    n, L = ids.shape
    W = (L + 31) // 32
    padL = W * 32
    idp = np.full((n, padL), -1, dtype=np.int64)
    idp[:, :L] = ids
    idp = idp.reshape(n, W, 32)
    weights = (UINT1 << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    peq = np.zeros((n, alphabet, W), dtype=np.uint32)
    # one pass per symbol: vectorised bit-packing
    for c in range(alphabet):
        mask = idp == c  # (n, W, 32)
        peq[:, c, :] = (mask * weights[None, None, :]).sum(
            axis=2, dtype=np.uint64
        ).astype(np.uint32)
    return peq


def _shift1(x, fill_bit):
    """Multi-word left-shift by one bit along the word axis (the LAST
    axis; (B, W) pair batches and (S, n, W) column blocks both work).

    fill_bit: uint32 0/1 scalar or (B, 1) shifted into word 0's LSB.
    """
    carry = jnp.concatenate(
        [
            jnp.broadcast_to(
                jnp.asarray(fill_bit, jnp.uint32), x.shape[:-1] + (1,)
            ),
            x[..., :-1] >> 31,
        ],
        axis=-1,
    )
    return (x << 1) | carry


def _add_with_carry(x, y):
    """Multi-word unsigned addition x + y over the (last) word axis
    with Kogge–Stone carry propagation."""
    s = x + y
    g = (s < x).astype(jnp.uint32)  # generate
    p = (s == UFULL).astype(jnp.uint32)  # propagate
    W = s.shape[-1]
    lead = [(0, 0)] * (s.ndim - 1)
    G, P = g, p
    k = 1
    while k < W:
        Gs = jnp.pad(G[..., :-k], lead + [(k, 0)])  # identity g=0
        Ps = jnp.pad(P[..., :-k], lead + [(k, 0)], constant_values=1)
        G = G | (P & Gs)
        P = P & Ps
        k *= 2
    carry_in = jnp.pad(G[..., :-1], lead + [(1, 0)])  # exclusive
    return s + carry_in


def _myers_batch_from_tables(planes_tab, ids_tab, Pi, Ti, la, lb):
    """Gather pair rows from the replicated dataset tables and run the
    batch kernel — the shape shard_map splits over the pair axis."""
    return _myers_batch(
        jnp.take(planes_tab, Pi, axis=2),
        la,
        jnp.take(ids_tab, Ti, axis=0),
        lb,
    )


def _pairs_from_tables(planes_tab, ids_tab, Pi, Ti, la, lb, kernel="xla",
                       interpret=False):
    """One pair tier on pre-swapped pairs: ``kernel="xla"`` gathers
    from the planes and runs ``_myers_batch``; ``"triton"`` runs the
    GPU kernel (ops/levenshtein_triton.py)."""
    if kernel == "xla":
        return _myers_batch_from_tables(planes_tab, ids_tab, Pi, Ti, la, lb)
    from annchor_tpu.ops.levenshtein_triton import triton_pairs

    return triton_pairs(
        planes_tab, ids_tab, Pi, Ti, la, lb, interpret=interpret
    )


_TIER_ARGS = ("kernel", "interpret")
_pairs_from_tables_jit = functools.partial(
    jax.jit, static_argnames=_TIER_ARGS
)(_pairs_from_tables)


@functools.lru_cache(maxsize=8)
def _pairs_from_tables_sharded(mesh, kernel, interpret):
    """shard_map'd pair tier: tables replicated, pair axis split over
    the 1-d ``pairs`` mesh (SURVEY.md §2.2: DP over pair batches)."""
    from jax.sharding import PartitionSpec as P

    return jax.jit(
        jax.shard_map(
            functools.partial(
                _pairs_from_tables, kernel=kernel, interpret=interpret
            ),
            mesh=mesh,
            in_specs=(P(), P(), P("pairs"), P("pairs"), P("pairs"),
                      P("pairs")),
            out_specs=P("pairs"),
            check_vma=False,
        )
    )


@jax.jit
def _myers_batch(planes, la, b_ids, lb):
    """Edit distance for a batch of pre-gathered pairs.

    planes: uint32 (K, 2, B, W) — bitplane-decomposed Peq tables of
            the *shorter* string of each pair (see build_planes; the
            bitplane select avoids a per-lane gather)
    la:  int32 (B,) pattern lengths (la <= lb)
    b_ids: int32 (B, L) dense alphabet ids of the text (pad -1)
    lb:  int32 (B,) text lengths
    Returns int32 (B,).
    """
    K, _, B, W = planes.shape
    la = la.astype(jnp.int32)
    lb = lb.astype(jnp.int32)

    # VP starts with the first `la` bits set
    word_base = jnp.arange(W, dtype=jnp.int32)[None, :] * 32
    nbits = jnp.clip(la[:, None] - word_base, 0, 32)
    VP0 = jnp.where(
        nbits >= 32,
        UFULL,
        (UINT1 << nbits.astype(jnp.uint32)) - UINT1,
    ).astype(jnp.uint32)
    VN0 = jnp.zeros((B, W), dtype=jnp.uint32)

    # score tap: one-hot uint32 mask with bit (la-1) set in its word
    # (masked reduce instead of a per-pair word gather)
    m1 = jnp.maximum(la - 1, 0)
    tap = jnp.where(
        jnp.arange(W, dtype=jnp.int32)[None, :] == (m1 >> 5)[:, None],
        (UINT1 << (m1 & 31).astype(jnp.uint32))[:, None],
        jnp.uint32(0),
    )

    score0 = la
    result0 = jnp.where(la == 0, lb, 0)

    max_lb = jnp.max(lb)

    def step(j, VP, VN, score, result):
        cj = jax.lax.dynamic_slice_in_dim(b_ids, j, 1, axis=1)  # (B,1)
        # Eq = AND_k planes[k][bit_k(cj)] — K selects, no gather
        Eq = None
        for k in range(K):
            bit = ((cj >> k) & 1).astype(jnp.uint32)  # (B,1)
            sel = jnp.where(bit == 1, planes[k, 1], planes[k, 0])
            Eq = sel if Eq is None else (Eq & sel)
        Eq = jnp.where(cj >= 0, Eq, jnp.uint32(0))

        Xv = Eq | VN
        D0 = (_add_with_carry(Eq & VP, VP) ^ VP) | Xv
        HP = VN | ~(D0 | VP)
        HN = VP & D0

        hp_hit = jnp.any((HP & tap) != 0, axis=1)
        hn_hit = jnp.any((HN & tap) != 0, axis=1)
        inc = hp_hit.astype(jnp.int32) - hn_hit.astype(jnp.int32)
        active = (j < lb) & (la > 0)
        score = score + jnp.where(active, inc, 0)
        result = jnp.where((j == lb - 1) & (la > 0), score, result)

        X = _shift1(HP, UINT1)
        HNs = _shift1(HN, jnp.uint32(0))
        VP = HNs | ~(D0 | X)
        VN = X & D0
        return VP, VN, score, result

    # two text characters per loop iteration: the per-step work here is
    # small, so the sequential fori_loop's step overhead is what bounds
    # the kernel — halving the trip count is ~1.5-2x wall time
    def body(t, carry):
        carry = step(t * 2, *carry)
        return step(t * 2 + 1, *carry)

    _, _, _, result = jax.lax.fori_loop(
        0, (max_lb + 1) // 2, body, (VP0, VN0, score0, result0)
    )
    return result


@jax.jit
def _myers_column(planes, la_all, t_ids, t_len):
    """Edit distance from ONE text string to every dataset string.

    One-vs-all structure: the text character at step j is a
    *scalar*, so Eq is K broadcast bitplane selects on a scalar bit —
    no per-lane gather and no per-step dynamic slice of the peq
    table.  Used for anchor/query distance columns (reference
    pickers.py:43-50 hot loop #1).

    planes: uint32 (K, 2, n, W) — bitplane-decomposed Peq tables
    la_all: int32 (n,) pattern lengths
    t_ids: int32 (L,) dense alphabet ids of the text (pad -1)
    t_len: int32 scalar text length
    Returns int32 (n,) edit distances.
    """
    K, _, n, W = planes.shape
    la = la_all.astype(jnp.int32)

    word_base = jnp.arange(W, dtype=jnp.int32)[None, :] * 32
    nbits = jnp.clip(la[:, None] - word_base, 0, 32)
    VP0 = jnp.where(
        nbits >= 32, UFULL, (UINT1 << nbits.astype(jnp.uint32)) - UINT1
    ).astype(jnp.uint32)
    VN0 = jnp.zeros((n, W), dtype=jnp.uint32)

    # tap masks instead of per-row word gathers (same trick as the
    # batch kernel): one-hot word mask holding bit (la-1)
    m1 = jnp.maximum(la - 1, 0)
    tap = jnp.where(
        jnp.arange(W, dtype=jnp.int32)[None, :] == (m1 >> 5)[:, None],
        (UINT1 << (m1 & 31).astype(jnp.uint32))[:, None],
        jnp.uint32(0),
    )

    def step(j, VP, VN, score):
        live = j < t_len  # unrolled loop may overshoot by one char
        cj = t_ids[jnp.minimum(j, t_ids.shape[0] - 1)]
        cju = jnp.clip(cj, 0, None).astype(jnp.uint32)
        Eq = None
        for k in range(K):
            bit = (cju >> k) & UINT1  # scalar select bit
            sel = jnp.where(bit == 1, planes[k, 1], planes[k, 0])
            Eq = sel if Eq is None else (Eq & sel)
        Eq = jnp.where(cj >= 0, Eq, jnp.uint32(0))
        Xv = Eq | VN
        D0 = (_add_with_carry(Eq & VP, VP) ^ VP) | Xv
        HP = VN | ~(D0 | VP)
        HN = VP & D0
        hp = jnp.any((HP & tap) != 0, axis=1)
        hn = jnp.any((HN & tap) != 0, axis=1)
        inc = hp.astype(jnp.int32) - hn.astype(jnp.int32)
        score = score + jnp.where(live, inc, 0)
        X = _shift1(HP, UINT1)
        HNs = _shift1(HN, jnp.uint32(0))
        VP = jnp.where(live, HNs | ~(D0 | X), VP)
        VN = jnp.where(live, X & D0, VN)
        return VP, VN, score

    # two characters per trip: step overhead bounds this kernel
    def body(t, carry):
        carry = step(t * 2, *carry)
        return step(t * 2 + 1, *carry)

    _, _, score = jax.lax.fori_loop(
        0, (t_len + 1) // 2, body, (VP0, VN0, la)
    )
    # empty pattern: distance is the text length
    return jnp.where(la == 0, t_len, score)


@functools.partial(jax.jit, static_argnames=("na",))
def _myers_maxmin(planes, la_all, ids, first_ix, na: int):
    """Fused greedy max-min anchor selection: the entire
    anchors-times-columns loop runs as ONE device program (replaces
    na sequential host-driven column evaluations, reference
    pickers.py:18-52 incl. the D[1:] quirk at pickers.py:48-50).

    Returns (A int32 (na,), D int32 (na, n)).
    """
    n = planes.shape[2]
    D0 = jnp.zeros((na, n), dtype=jnp.int32)
    A0 = jnp.zeros((na,), dtype=jnp.int32)
    row_ids = jnp.arange(na, dtype=jnp.int32)

    def body(i, carry):
        D, A, ix = carry
        col = _myers_column(
            planes, la_all, jnp.take(ids, ix, axis=0), jnp.take(la_all, ix)
        )
        D = jax.lax.dynamic_update_slice_in_dim(D, col[None, :], i, axis=0)
        A = A.at[i].set(ix)
        # reference quirk: the running min EXCLUDES the first anchor's
        # column (pickers.py:48-50 uses D[1:])
        live = (row_ids >= 1) & (row_ids <= i)
        minD = jnp.min(
            jnp.where(live[:, None], D, np.int32(2**30)), axis=0
        )
        nxt = jnp.where(i == 0, jnp.argmax(col), jnp.argmax(minD))
        return D, A, nxt.astype(jnp.int32)

    D, A, _ = jax.lax.fori_loop(
        0, na, body, (D0, A0, jnp.asarray(first_ix, jnp.int32))
    )
    return A, D


def myers_maxmin(enc: "MyersEncoding", na: int, first_ix: int):
    """Host wrapper for the fused max-min anchor kernel."""
    _, planes, ids, la = enc.device_arrays()
    A, D = _myers_maxmin(planes, la, ids, int(first_ix), na)
    return np.asarray(A), np.asarray(D, dtype=np.float64).T


def myers_columns(enc: "MyersEncoding", ixs):
    """Distance columns for a set of source indices (one-vs-all),
    one fused dispatch per column."""
    _, planes, ids, la = enc.device_arrays()
    cols = [
        np.asarray(
            _myers_column(
                planes, la, jnp.take(ids, int(ix), axis=0), int(enc.lengths[ix])
            )
        )
        for ix in np.asarray(ixs, dtype=np.int64)
    ]
    return np.stack(cols, axis=0)


@jax.jit
def _myers_columns_block(planes, la_all, t_ids, t_len):
    """One-vs-all columns for a BLOCK of text strings in one program.

    The scalar-text-char trick of ``_myers_column`` generalises: at
    step j the block's text characters are an (S,) vector, so Eq is K
    per-source broadcast selects over the shared (n, W) bitplane table
    — still no per-lane gather, and the (S, n, W) state amortises the
    sequential loop's step overhead over S sources at once.  This is
    the exact-ground-truth workhorse (blocked exact k-NN at 20k-100k
    points: reference contract tests/test_annchor.py:95-102 compares
    every row against an exact graph).

    planes: uint32 (K, 2, n, W); la_all: int32 (n,)
    t_ids: int32 (S, L) dense ids (pad -1); t_len: int32 (S,)
    Returns int32 (S, n).
    """
    K, _, n, W = planes.shape
    S = t_ids.shape[0]
    la = la_all.astype(jnp.int32)

    word_base = jnp.arange(W, dtype=jnp.int32)[None, :] * 32
    nbits = jnp.clip(la[:, None] - word_base, 0, 32)
    VP0 = jnp.where(
        nbits >= 32, UFULL, (UINT1 << nbits.astype(jnp.uint32)) - UINT1
    ).astype(jnp.uint32)
    VP0 = jnp.broadcast_to(VP0[None], (S, n, W))
    VN0 = jnp.zeros((S, n, W), dtype=jnp.uint32)

    m1 = jnp.maximum(la - 1, 0)
    tap = jnp.where(
        jnp.arange(W, dtype=jnp.int32)[None, :] == (m1 >> 5)[:, None],
        (UINT1 << (m1 & 31).astype(jnp.uint32))[:, None],
        jnp.uint32(0),
    )[None]  # (1, n, W)

    t_len = t_len.astype(jnp.int32)
    score0 = jnp.broadcast_to(la[None], (S, n))

    def step(j, VP, VN, score):
        live = (j < t_len)[:, None, None]  # (S, 1, 1)
        cj = t_ids[:, jnp.minimum(j, t_ids.shape[1] - 1)]  # (S,)
        cju = jnp.clip(cj, 0, None).astype(jnp.uint32)
        Eq = None
        for k in range(K):
            bit = ((cju >> k) & UINT1)[:, None, None]  # (S,1,1)
            sel = jnp.where(bit == 1, planes[k, 1][None], planes[k, 0][None])
            Eq = sel if Eq is None else (Eq & sel)
        Eq = jnp.where((cj >= 0)[:, None, None], Eq, jnp.uint32(0))
        Xv = Eq | VN
        D0 = (_add_with_carry(Eq & VP, VP) ^ VP) | Xv
        HP = VN | ~(D0 | VP)
        HN = VP & D0
        hp = jnp.any((HP & tap) != 0, axis=-1)
        hn = jnp.any((HN & tap) != 0, axis=-1)
        inc = hp.astype(jnp.int32) - hn.astype(jnp.int32)
        score = score + jnp.where(live[..., 0], inc, 0)
        X = _shift1(HP, UINT1)
        HNs = _shift1(HN, jnp.uint32(0))
        VP = jnp.where(live, HNs | ~(D0 | X), VP)
        VN = jnp.where(live, X & D0, VN)
        return VP, VN, score

    def body(t, carry):
        carry = step(t * 2, *carry)
        return step(t * 2 + 1, *carry)

    _, _, score = jax.lax.fori_loop(
        0, (jnp.max(t_len) + 1) // 2, body, (VP0, VN0, score0)
    )
    return jnp.where(la[None] == 0, t_len[:, None], score)


@functools.partial(jax.jit, static_argnames=("k", "n_keep"))
def _columns_block_topk(planes, la_all, t_ids, t_len, k: int, n_keep: int):
    """Block columns + device k-smallest: only (S, k) crosses the link."""
    d = _myers_columns_block(planes, la_all, t_ids, t_len)[:, :n_keep]
    neg, idx = jax.lax.top_k(-d, k)
    return -neg, idx


def myers_knn(enc: "MyersEncoding", k: int, rows=None, block: int = 64,
              n_keep=None, verbose: bool = False):
    """Exact k-smallest distances per source row, blocked one-vs-all.

    Never materialises the O(n^2) matrix: each block of ``block``
    sources runs as one device program ending in ``top_k``, and only
    (block, k) indices+distances are downloaded.  ``rows=None`` means
    every string (a full exact k-NN graph — incl. the self column when
    k counts it); ``n_keep`` restricts candidate columns to a prefix
    of the encoding (query-vs-dataset use).
    Returns (idx int64 (R, k), dist float64 (R, k)), ascending.
    """
    from annchor_tpu.progress import progress

    _, planes, ids, la = enc.device_arrays()
    n = planes.shape[2]
    if n_keep is None:
        n_keep = n
    if rows is None:
        rows = np.arange(n, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    idx_out = np.empty((rows.shape[0], k), dtype=np.int64)
    dist_out = np.empty((rows.shape[0], k), dtype=np.float64)
    for s in progress(
        range(0, rows.shape[0], block), "exact rows", verbose
    ):
        blk = rows[s : s + block]
        d, ix = _columns_block_topk(
            planes, la,
            jnp.take(ids, jnp.asarray(blk), axis=0),
            jnp.asarray(enc.lengths[blk]),
            int(k), int(n_keep),
        )
        dist_out[s : s + blk.shape[0]] = np.asarray(d)
        idx_out[s : s + blk.shape[0]] = np.asarray(ix)
    return idx_out, dist_out


def myers_rows(enc: "MyersEncoding", rows, block: int = 64, n_keep=None,
               verbose: bool = False):
    """Full exact distance rows (R, n_keep) for the given sources."""
    from annchor_tpu.progress import progress

    _, planes, ids, la = enc.device_arrays()
    n = planes.shape[2]
    if n_keep is None:
        n_keep = n
    rows = np.asarray(rows, dtype=np.int64)
    out = np.empty((rows.shape[0], n_keep), dtype=np.float64)
    for s in progress(
        range(0, rows.shape[0], block), "exact rows", verbose
    ):
        blk = rows[s : s + block]
        d = _myers_columns_block(
            planes, la,
            jnp.take(ids, jnp.asarray(blk), axis=0),
            jnp.asarray(enc.lengths[blk]),
        )
        out[s : s + blk.shape[0]] = np.asarray(d[:, :n_keep])
    return out


class MyersEncoding:
    """Per-dataset precomputation for the bit-parallel path.

    Device copies of the (immutable) tables are cached after the first
    transfer, so kernel calls never re-upload them."""

    __slots__ = (
        "ids", "lengths", "peq", "planes", "alphabet", "W", "_dev"
    )

    def __init__(self, ids, lengths, peq, alphabet):
        self.ids = ids
        self.lengths = np.asarray(lengths, dtype=np.int32)
        self.peq = peq
        self.planes = build_planes(peq, alphabet)
        self.alphabet = alphabet
        self.W = peq.shape[2]
        self._dev = None

    def device_arrays(self):
        """(peq, planes, ids, lengths); planes/ids/lengths as cached
        device arrays.  peq stays HOST-side: every kernel consumes the
        bitplane decomposition (planes), and uploading the raw
        (n, alphabet, W) table would waste n*alphabet*W*4 bytes of HBM
        and link time (1.3 GB at 500k points) for nothing."""
        if self._dev is None:
            self._dev = (
                self.peq,
                jnp.asarray(self.planes),
                jnp.asarray(self.ids),
                jnp.asarray(self.lengths),
            )
        return self._dev

    @classmethod
    def from_codes(cls, codes, lengths):
        enc = encode_alphabet(codes, lengths)
        if enc is None:
            return None
        ids, alphabet = enc
        peq = build_peq(ids, lengths, alphabet)
        # words past the longest string are all zero: drop them
        W = max(1, -(-int(np.max(lengths, initial=0)) // 32))
        return cls(ids, lengths, np.ascontiguousarray(peq[:, :, :W]),
                   alphabet)


def myers_pairs(
    enc: MyersEncoding,
    I,
    J,
    block_size: int = 8192,
    sort_by_length: bool = True,
    word_quantum: int = 4,
    mesh=None,
    kernel: str = "xla",
    interpret: bool = False,
):
    """Edit distances for pairs (I[k], J[k]) via the bit-parallel
    kernel, chunked and length-bucketed like
    ``levenshtein.levenshtein_pairs``.  ``kernel`` names the pair tier
    (``"xla"`` or ``"triton"``, see ``_pairs_from_tables``).

    Pairs are pre-swapped so the pattern (bitmasked side) is the
    shorter string; sorting by pattern length lets each block slice
    its Peq table to the fewest words (quantised to ``word_quantum``
    to bound the number of compiled variants).
    """
    I = np.asarray(I, dtype=np.int64)
    J = np.asarray(J, dtype=np.int64)
    m = I.shape[0]
    if m == 0:
        return np.zeros(0, dtype=np.int32)
    lengths = enc.lengths
    la = lengths[I]
    lb = lengths[J]
    swap = la > lb
    P = np.where(swap, J, I)  # pattern = shorter
    T = np.where(swap, I, J)  # text = longer
    la, lb = np.minimum(la, lb), np.maximum(la, lb)

    if sort_by_length and m > block_size:
        order = np.argsort(la, kind="stable")
    else:
        order = np.arange(m)

    out = np.zeros(m, dtype=np.int32)
    _, planes_d, ids_d, _ = enc.device_arrays()
    tier = dict(kernel=kernel, interpret=interpret)
    if mesh is not None:
        run = _pairs_from_tables_sharded(mesh, **tier)
    else:
        run = functools.partial(_pairs_from_tables_jit, **tier)
    # dispatch every block async and download ONCE at the end, so
    # the host never waits on the device between blocks; per-program
    # temps are bounded (~54 MB at the default block), so queueing the
    # dispatches is safe
    pending = []
    for s in range(0, m, block_size):
        sel = order[s : s + block_size]
        bsz = sel.shape[0]
        if bsz < block_size:
            pad = np.zeros(block_size - bsz, dtype=np.int64)
            gp = np.concatenate([P[sel], pad])
            gt = np.concatenate([T[sel], pad])
            gla = np.concatenate([la[sel], np.zeros_like(pad, np.int32)])
            glb = np.concatenate([lb[sel], np.zeros_like(pad, np.int32)])
        else:
            gp, gt, gla, glb = P[sel], T[sel], la[sel], lb[sel]
        words = -(-max(int(gla.max()), 1) // 32)
        w_blk = min(-(-words // word_quantum) * word_quantum, enc.W)
        d = run(
            planes_d[..., :w_blk],
            ids_d,
            jnp.asarray(gp),
            jnp.asarray(gt),
            jnp.asarray(gla),
            jnp.asarray(glb),
        )
        pending.append((sel, bsz, d))
    if len(pending) == 1:
        sel, bsz, d = pending[0]
        out[sel] = np.asarray(d)[:bsz]
    elif pending:
        flat = np.asarray(jnp.concatenate([d for _, _, d in pending]))
        off = 0
        for sel, bsz, _ in pending:
            out[sel] = flat[off : off + bsz]
            off += block_size
    return out


def _pairs_dev_impl(planes_tab, ids_tab, lengths, I, J, kernel="xla",
                    interpret=False):
    """Pair eval from device-resident pair ids: the length lookup and
    the shorter-pattern swap happen in-program, so a selection stage
    can chain straight into the kernel with no host hop."""
    la = jnp.take(lengths, I)
    lb = jnp.take(lengths, J)
    swap = la > lb
    P = jnp.where(swap, J, I)
    T = jnp.where(swap, I, J)
    return _pairs_from_tables(
        planes_tab, ids_tab, P, T, jnp.minimum(la, lb), jnp.maximum(la, lb),
        kernel=kernel, interpret=interpret,
    )


_pairs_dev_jit = functools.partial(jax.jit, static_argnames=_TIER_ARGS)(
    _pairs_dev_impl
)


@functools.lru_cache(maxsize=8)
def _pairs_dev_sharded(mesh, kernel, interpret):
    """Device-id pair eval split over the ``pairs`` mesh (tables and
    lengths replicated); the batch must be a multiple of mesh.size."""
    from jax.sharding import PartitionSpec as P

    return jax.jit(
        jax.shard_map(
            functools.partial(
                _pairs_dev_impl, kernel=kernel, interpret=interpret
            ),
            mesh=mesh,
            in_specs=(P(), P(), P(), P("pairs"), P("pairs")),
            out_specs=P("pairs"),
            check_vma=False,
        )
    )


def myers_pairs_dev(enc: MyersEncoding, I, J, kernel: str = "xla",
                    interpret: bool = False, mesh=None):
    """Device-id twin of myers_pairs: I, J are device int32 arrays;
    returns a device int32 (B,) array (no download).  With ``mesh``
    the batch (a multiple of mesh.size) is split over the mesh, which
    a hand-written kernel needs: XLA cannot partition it by itself."""
    _, planes_d, ids_d, lengths_d = enc.device_arrays()
    tier = dict(kernel=kernel, interpret=interpret)
    if mesh is not None:
        return _pairs_dev_sharded(mesh, **tier)(
            planes_d, ids_d, lengths_d, I, J
        )
    return _pairs_dev_jit(planes_d, ids_d, lengths_d, I, J, **tier)
