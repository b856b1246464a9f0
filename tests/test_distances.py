"""Metric kernels vs oracles (reference tests/test_distances.py:6-19,
extended with batched-kernel parity checks per SURVEY.md §4)."""

import numpy as np
import pytest

from annchor_tpu.distances import cosine, euclidean, levenshtein
from annchor_tpu.ops.levenshtein import (
    _lev_batch,
    encode_strings,
    levenshtein_pairs,
    levenshtein_scalar,
)


def _py_lev(a: str, b: str) -> int:
    """Pure-python oracle (independent of the library code paths)."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (a[i - 1] != b[j - 1]),
            )
        prev = cur
    return prev[lb]


def _random_strings(rng, n, max_len=40, alphabet="abcde"):
    out = []
    for _ in range(n):
        L = int(rng.integers(0, max_len))
        out.append("".join(rng.choice(list(alphabet), size=L)))
    return out


def test_scalar_distances():
    # reference tests/test_distances.py:6-19
    assert levenshtein("cat", "cart") == 1
    assert levenshtein("cat", "dog") == 3
    assert levenshtein("", "abc") == 3
    assert euclidean(np.array([0, 0]), np.array([3, 4])) == pytest.approx(5.0)
    assert cosine(np.array([1.0, 0.0]), np.array([0.0, 1.0])) == (
        pytest.approx(1.0)
    )
    assert cosine(np.array([2.0, 0.0]), np.array([5.0, 0.0])) == (
        pytest.approx(0.0)
    )


def test_levenshtein_scalar_matches_oracle(rng):
    strs = _random_strings(rng, 30)
    for _ in range(60):
        i, j = rng.integers(0, len(strs), size=2)
        assert levenshtein_scalar(strs[i], strs[j]) == _py_lev(
            strs[i], strs[j]
        )


def test_batched_levenshtein_matches_oracle(rng):
    """The XLA cummin-row DP against the pure-python DP, mixed lengths
    including empty strings (replaces the reference's reliance on the
    python-Levenshtein C extension, reference distances.py:16-20)."""
    strs = _random_strings(rng, 64, max_len=50)
    strs[0] = ""  # edge: empty string
    strs[1] = "a"
    codes, lengths = encode_strings(strs)
    m = 300
    I = rng.integers(0, len(strs), size=m)
    J = rng.integers(0, len(strs), size=m)
    got = levenshtein_pairs(codes, lengths, I, J, block_size=128)
    want = np.array([_py_lev(strs[i], strs[j]) for i, j in zip(I, J)])
    np.testing.assert_array_equal(got, want)


def test_batched_levenshtein_unsorted_blocks(rng):
    strs = _random_strings(rng, 20, max_len=30)
    codes, lengths = encode_strings(strs)
    I = rng.integers(0, 20, size=64)
    J = rng.integers(0, 20, size=64)
    a = levenshtein_pairs(codes, lengths, I, J, sort_by_length=False)
    b = levenshtein_pairs(codes, lengths, I, J, sort_by_length=True)
    np.testing.assert_array_equal(a, b)


def test_lev_batch_kernel_swapped_args(rng):
    """Symmetry: d(a, b) == d(b, a) regardless of which side walks the
    rows."""
    import jax.numpy as jnp

    strs = ["kitten", "sitting", "flaw", "lawn"]
    codes, lengths = encode_strings(strs)
    a = jnp.asarray(codes[[0, 2]])
    b = jnp.asarray(codes[[1, 3]])
    la = jnp.asarray(lengths[[0, 2]])
    lb = jnp.asarray(lengths[[1, 3]])
    d1 = np.asarray(_lev_batch(a, b, la, lb))
    d2 = np.asarray(_lev_batch(b, a, lb, la))
    np.testing.assert_array_equal(d1, [3, 2])
    np.testing.assert_array_equal(d1, d2)


def test_native_lev_batch_matches_oracle(rng):
    from annchor_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    strs = _random_strings(rng, 32, max_len=40)
    codes, lengths = encode_strings(strs)
    I = rng.integers(0, 32, size=100).astype(np.int64)
    J = rng.integers(0, 32, size=100).astype(np.int64)
    got = native.lev_batch(codes, lengths, I, J)
    want = np.array([_py_lev(strs[i], strs[j]) for i, j in zip(I, J)])
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# optimal transport


def _emd_1d_oracle(a, b):
    """Exact 1-Wasserstein for 1-d histograms on the line with
    cost |i - j|: the L1 distance between the CDFs."""
    a = a / a.sum()
    b = b / b.sum()
    return float(np.abs(np.cumsum(a) - np.cumsum(b)).sum())


def test_native_emd_matches_1d_oracle(rng):
    from annchor_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    n = 16
    C = np.abs(
        np.arange(n)[:, None] - np.arange(n)[None, :]
    ).astype(np.float64)
    for _ in range(25):
        a = rng.random(n)
        b = rng.random(n)
        a[rng.random(n) < 0.3] = 0.0  # sparse supports
        b[rng.random(n) < 0.3] = 0.0
        if a.sum() == 0 or b.sum() == 0:
            continue
        got = native.emd_single(a, b, C)
        assert got == pytest.approx(_emd_1d_oracle(a, b), abs=1e-9)


def test_native_emd_metric_properties(rng):
    from annchor_tpu import native
    from annchor_tpu.datasets import grid_cost_matrix

    if not native.available():
        pytest.skip("native toolchain unavailable")
    M = grid_cost_matrix(4, 4)
    X = rng.random((12, 16))
    X[X < 0.4] = 0.0
    X[0] = X[1]  # identical rows -> distance 0
    I, J = np.triu_indices(12, k=1)
    d = native.emd_batch(X, X, M, I, J)
    D = np.zeros((12, 12))
    D[I, J] = d
    D += D.T
    assert D[0, 1] == pytest.approx(0.0, abs=1e-12)
    # symmetry is by construction; check triangle inequality
    for i in range(12):
        for j in range(12):
            for k in range(12):
                assert D[i, j] <= D[i, k] + D[k, j] + 1e-9


def test_emd_batch_matches_single(rng):
    from annchor_tpu import native
    from annchor_tpu.datasets import grid_cost_matrix

    if not native.available():
        pytest.skip("native toolchain unavailable")
    M = grid_cost_matrix(3, 3)
    X = rng.random((6, 9))
    IJ = np.array([[0, 1], [2, 3], [4, 5], [1, 4]])
    batch = native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1])
    single = [native.emd_single(X[i], X[j], M) for i, j in IJ]
    np.testing.assert_allclose(batch, single, atol=1e-12)


def test_sinkhorn_close_to_exact(rng):
    from annchor_tpu import native
    from annchor_tpu.datasets import grid_cost_matrix
    from annchor_tpu.ops.wasserstein import SinkhornEngine

    if not native.available():
        pytest.skip("native toolchain unavailable")
    M = grid_cost_matrix(4, 4)
    X = rng.random((8, 16))
    eng = SinkhornEngine(M, eps=0.005, n_iter=500)
    IJ = np.stack([np.arange(4), np.arange(4, 8)], axis=1)
    approx = eng(X, X, IJ)
    exact = native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1])
    # entropic bias is bounded; must track the exact value closely
    np.testing.assert_allclose(approx, exact, rtol=0.08, atol=0.05)


# ---------------------------------------------------------------------------
# bit-parallel (Myers) kernels


def test_myers_pairs_matches_oracle(rng):
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding,
        myers_pairs,
    )

    strs = _random_strings(rng, 48, max_len=120, alphabet="abcdefgh")
    strs[0] = ""
    strs[1] = "a" * 32          # word-boundary edge
    strs[2] = "b" * 33
    strs[3] = "ab" * 40
    codes, lengths = encode_strings(strs)
    enc = MyersEncoding.from_codes(codes, lengths)
    assert enc is not None
    I = rng.integers(0, len(strs), size=400)
    J = rng.integers(0, len(strs), size=400)
    got = myers_pairs(enc, I, J, block_size=128)
    want = np.array([_py_lev(strs[i], strs[j]) for i, j in zip(I, J)])
    np.testing.assert_array_equal(got, want)


def test_myers_column_matches_oracle(rng):
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding,
        myers_columns,
    )

    strs = _random_strings(rng, 40, max_len=80)
    strs[5] = ""
    codes, lengths = encode_strings(strs)
    enc = MyersEncoding.from_codes(codes, lengths)
    cols = myers_columns(enc, [0, 5, 17])
    for row, src in zip(cols, (0, 5, 17)):
        want = [_py_lev(strs[src], s) for s in strs]
        np.testing.assert_array_equal(row, want)


def test_myers_maxmin_matches_host_loop(rng):
    """The fused device max-min must pick the same anchors as the
    sequential host loop (incl. the reference D[1:] quirk)."""
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding,
        myers_maxmin,
    )

    strs = _random_strings(rng, 60, max_len=60)
    codes, lengths = encode_strings(strs)
    enc = MyersEncoding.from_codes(codes, lengths)
    na, first = 8, 11
    A, D = myers_maxmin(enc, na, first)

    # host re-implementation of the same greedy rule
    Dh = np.full((na, len(strs)), np.inf)
    Ah = np.zeros(na, dtype=int)
    ix = first
    for i in range(na):
        Ah[i] = ix
        Dh[i] = [_py_lev(strs[ix], s) for s in strs]
        ix = int(
            np.argmax(Dh[0]) if i == 0 else np.argmax(np.min(Dh[1:], axis=0))
        )
    np.testing.assert_array_equal(A, Ah)
    np.testing.assert_allclose(D, Dh.T)


def test_myers_alphabet_fallback(rng):
    """Huge alphabets disable the bit-parallel path gracefully."""
    from annchor_tpu.ops import levenshtein_myers as lm

    codes = rng.integers(0, 100000, size=(4, 64)).astype(np.int32)
    lengths = np.full(4, 64, dtype=np.int32)
    old = lm.MAX_ALPHABET
    try:
        lm.MAX_ALPHABET = 16
        assert lm.MyersEncoding.from_codes(codes, lengths) is None
    finally:
        lm.MAX_ALPHABET = old


def test_netsimplex_matches_ssp(rng):
    """The network-simplex EMD against the independent SSP solver on
    2-d grid costs (two exact algorithms must agree bit-tight)."""
    from annchor_tpu import native
    from annchor_tpu.datasets import grid_cost_matrix

    if not native.available():
        pytest.skip("native toolchain unavailable")
    M = grid_cost_matrix(6, 6)
    for _ in range(60):
        a = rng.random(36)
        b = rng.random(36)
        a[rng.random(36) < 0.5] = 0.0
        b[rng.random(36) < 0.5] = 0.0
        if a.sum() == 0 or b.sum() == 0:
            continue
        ns = native.emd_single(a, b, M)
        ssp = native.emd_single_ssp(a, b, M)
        assert ns == pytest.approx(ssp, abs=1e-10)


def _swapped(enc, I, J):
    """Pairs pre-swapped so the pattern is the shorter string."""
    import jax.numpy as jnp

    la, lb = enc.lengths[I], enc.lengths[J]
    sw = la > lb
    return [
        jnp.asarray(np.asarray(a, dtype=np.int32))
        for a in (np.where(sw, J, I), np.where(sw, I, J),
                  np.minimum(la, lb), np.maximum(la, lb))
    ]


def test_pallas_myers_matches_oracle(rng):
    """The Triton-route Pallas kernel in interpret mode against the
    python oracle — same contract as the XLA Myers kernel (empty
    strings and an exact 33-char word boundary included)."""
    from annchor_tpu.ops.levenshtein_myers import MyersEncoding
    from annchor_tpu.ops.levenshtein_triton import triton_pairs

    strs = _random_strings(rng, 40, max_len=100, alphabet="abcdef")
    strs[0] = ""
    strs[1] = "a" * 33
    codes, lengths = encode_strings(strs)
    enc = MyersEncoding.from_codes(codes, lengths)
    I = rng.integers(0, len(strs), size=300)
    J = rng.integers(0, len(strs), size=300)
    want = np.array([_py_lev(strs[i], strs[j]) for i, j in zip(I, J)])
    _, planes_d, ids_d, _ = enc.device_arrays()
    got = triton_pairs(
        planes_d, ids_d, *_swapped(enc, I, J), interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_pallas_matches_xla_myers(rng):
    """The engine-facing host path with the Triton tier (interpret
    mode) against the XLA tier, over several pair blocks."""
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding,
        myers_pairs,
    )

    strs = _random_strings(rng, 64, max_len=200, alphabet="abcdefghij")
    codes, lengths = encode_strings(strs)
    enc = MyersEncoding.from_codes(codes, lengths)
    I = rng.integers(0, 64, size=2100)
    J = rng.integers(0, 64, size=2100)
    np.testing.assert_array_equal(
        myers_pairs(enc, I, J, block_size=1024, kernel="triton",
                    interpret=True),
        myers_pairs(enc, I, J),
    )


def test_pallas_tile_scales_with_shape(rng):
    """Block size and padding at W ~ 56 words: batches that are not a
    multiple of the kernel's TILE are padded and sliced back, the
    table's word axis may be cut to the batch's widest pattern, and
    long strings still match the XLA oracle."""
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding,
        myers_pairs,
    )
    from annchor_tpu.ops.levenshtein_triton import TILE, triton_pairs

    strs = _random_strings(rng, 24, max_len=1790, alphabet="ab")
    strs[0] = "ab" * 895  # 1790 chars: W = 56 words
    codes, lengths = encode_strings(strs)
    enc = MyersEncoding.from_codes(codes, lengths)
    assert enc.W == 56
    I = rng.integers(0, 24, size=TILE + 37)
    J = rng.integers(0, 24, size=TILE + 37)
    want = myers_pairs(enc, I, J)
    _, planes_d, ids_d, _ = enc.device_arrays()
    got = triton_pairs(
        planes_d, ids_d, *_swapped(enc, I, J), interpret=True
    )
    assert got.shape == (TILE + 37,)
    np.testing.assert_array_equal(np.asarray(got), want)
    # a word-sliced table serves batches whose patterns fit in it
    short = np.flatnonzero(enc.lengths <= 32 * 8)
    Is = rng.choice(short, size=50)
    Js = rng.integers(0, 24, size=50)
    got = triton_pairs(
        planes_d[..., :8], ids_d, *_swapped(enc, Is, Js), interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), myers_pairs(enc, Is, Js))
