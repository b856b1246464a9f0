"""Smoke test of the main path on one GPU (or, with --four-cards, the
sharded fit on four).

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # the four-card sharded fit only

Phases, in one process, in order; any failure raises and the process
exits non-zero without printing a result line:

0. device: print the nvidia-smi name and power limit, require a GPU.
1. kernels at real widths against plain references: every Myers pair
   tier the engine uses and the column kernels against the native C++
   DP, the Sinkhorn scout against a float64 NumPy Sinkhorn, the rms
   band score and the cosine column against float64 NumPy.
2. the 1600-string headline: BruteForce (ground truth), the reference
   README fit, and a query of mutated training strings.
3. the 20k-string scale path (device-resident pairs, budgeted build)
   checked against exact rows.
4. the digits-shaped Wasserstein scout/certify hybrid, every reported
   edge re-checked against native exact EMD.

The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# phase 1 widths: (n, length) of datasets.make_strings sets
KERNEL_SETS = ((1600, 500), (2000, 400), (256, 1800), (256, 3200))
KERNEL_PAIRS = 4096
SINKHORN_PAIRS = 4096
SINKHORN_RTOL = 1e-4
# The reference's budget (error < 15, tests/test_annchor.py) is for its
# real 1600-string set, which the tree does not hold.  make_strings()
# is a star-topology stand-in whose nearest neighbours share one flat
# distance band; the reference invocation makes 2,108 errors on it on
# the CPU and on the GPU alike.  This budget guards that count.
HEADLINE_ERROR_BUDGET = 2500
HEADLINE_GT_ROWS = 8
SCALE_N, SCALE_LENGTH, SCALE_K, SCALE_P_WORK = 20000, 400, 15, 0.01
SCALE_CHECK_ROWS = 128
FOUR_CARD_PAIR_CAP = 140


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi listed no GPU")
    return out


def require_gpu(devices, count=None):
    """The devices must be GPUs (and ``count`` of them); no fallback."""
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found platform {platform!r}"
        )
    if count is not None and len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devices)}")
    return devices


def result_line(devices) -> str:
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


class Phase:
    """Prints the phase's wall time (device work synced by callers)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"   phase {self.name} ok in "
                f"{time.perf_counter() - self.t0:.3f} s")


# ---------------------------------------------------------------------
# phase 1: kernels against plain references


def _pairs_vs_native(enc, codes, lengths, tiers, n_pairs, rng):
    import jax

    from annchor_tpu import native
    from annchor_tpu.ops.levenshtein_myers import myers_pairs_dev

    n = lengths.shape[0]
    I = rng.integers(n, size=n_pairs)
    J = rng.integers(n, size=n_pairs)
    want = native.lev_batch(codes, lengths, I, J)
    Id = jax.numpy.asarray(I.astype(np.int32))
    Jd = jax.numpy.asarray(J.astype(np.int32))
    for tier in tiers:
        got = np.asarray(myers_pairs_dev(enc, Id, Jd, **tier))
        bad = int((got != want).sum())
        log(f"   pairs {tier['kernel']}: "
            f"{bad} mismatches of {n_pairs}")
        assert bad == 0, f"{tier} disagrees with the native DP"


def _columns_vs_native(enc, codes, lengths, n_cols, rng):
    import jax.numpy as jnp

    from annchor_tpu import native
    from annchor_tpu.ops.levenshtein_myers import (
        _myers_column,
        _myers_columns_block,
    )

    n = lengths.shape[0]
    src = rng.choice(n, size=n_cols, replace=False)
    _, planes, ids, la = enc.device_arrays()
    block = np.asarray(_myers_columns_block(
        planes, la, jnp.take(ids, jnp.asarray(src), axis=0),
        jnp.asarray(enc.lengths[src]),
    ))
    all_j = np.arange(n)
    for r, s in enumerate(src):
        want = native.lev_batch(codes, lengths, np.full(n, s), all_j)
        col = np.asarray(_myers_column(
            planes, la, jnp.take(ids, int(s), axis=0), int(lengths[s])
        ))
        assert np.array_equal(col, want), f"_myers_column row {s}"
        assert np.array_equal(block[r], want), f"_myers_columns_block {s}"
    log(f"   columns: _myers_column and _myers_columns_block equal "
        f"on {n_cols} columns x {n}")


def phase_kernels_strings(sets=KERNEL_SETS, n_pairs=KERNEL_PAIRS,
                          n_cols=16, seed=0):
    from annchor_tpu.datasets import make_strings
    from annchor_tpu.metrics import _LevenshteinEngine
    from annchor_tpu.ops import levenshtein as lev_ops
    from annchor_tpu.ops.levenshtein_myers import MyersEncoding

    rng = np.random.default_rng(seed)
    engine = _LevenshteinEngine()
    for n, length in sets:
        X, _ = make_strings(n=n, length=length, seed=seed)
        codes, lengths = lev_ops.encode_strings(list(X))
        enc = MyersEncoding.from_codes(codes, lengths)
        chosen = engine._tier(enc)
        tiers = [dict(chosen, kernel="xla")]
        if chosen["kernel"] != "xla":
            tiers.append(chosen)
        log(f"   strings n={n} length={length}: W={enc.W}, engine tier "
            f"{chosen['kernel']}")
        _pairs_vs_native(enc, codes, lengths, tiers, n_pairs, rng)
        _columns_vs_native(enc, codes, lengths, n_cols, rng)


def digit_histograms(n=1797, seed=0):
    """Seeded 8x8 histograms shaped like the UCI digits (integer ink
    counts 0-16 on a centred blob, ~half the bins empty)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:8, 0:8]
    out = np.zeros((n, 64))
    for t in range(n):
        cy, cx = rng.uniform(2.5, 4.5, size=2)
        sy, sx = rng.uniform(1.2, 2.5, size=2)
        blob = np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2)
        ink = rng.poisson(16 * blob * rng.uniform(0.5, 1.0, size=(8, 8)))
        out[t] = np.minimum(ink, 16).reshape(-1)
        if out[t].sum() == 0:
            out[t, 27] = 1.0
    return out


def sinkhorn_f64(A, B, C, eps, n_iter):
    """Exp-domain Sinkhorn in float64 NumPy: the same iteration as the
    scout (ops/wasserstein._sinkhorn_exp_chunk)."""
    K = np.exp(-C / eps)
    KC = K * C
    tiny = 1e-35
    v = np.ones_like(B)
    for _ in range(n_iter):
        u = A / np.maximum(v @ K.T, tiny)
        v = B / np.maximum(u @ K, tiny)
    u = A / np.maximum(v @ K.T, tiny)
    return np.sum(u * (v @ KC.T), axis=1)


def phase_kernels_dense(n_pairs=SINKHORN_PAIRS, nx=SCALE_N, seed=0):
    import jax
    import jax.numpy as jnp

    from annchor_tpu.datasets import grid_cost_matrix
    from annchor_tpu.metrics import _DenseBatchEngine
    from annchor_tpu.ops.locality import _band_score
    from annchor_tpu.ops.wasserstein import SinkhornExpEngine

    rng = np.random.default_rng(seed)
    # Sinkhorn scout, 64 bins, precision HIGHEST on every matvec
    H = digit_histograms(seed=seed)
    M = grid_cost_matrix(8, 8)
    scout = SinkhornExpEngine(M)
    IJ = rng.integers(H.shape[0], size=(n_pairs, 2))
    got = scout(H, H, IJ)
    Hn = H / H.sum(axis=1, keepdims=True)
    want = sinkhorn_f64(Hn[IJ[:, 0]], Hn[IJ[:, 1]], M, scout.eps,
                        scout.n_iter)
    rel = float(np.max(np.abs(got - want) / np.maximum(want, 1e-12)))
    log(f"   sinkhorn scout: max rel err {rel:.3e} vs float64 "
        f"(tol {SINKHORN_RTOL:g}, f32 HIGHEST) on {n_pairs} pairs")
    assert rel <= SINKHORN_RTOL, "Sinkhorn scout off its float64 reference"

    # rms band score at the scale path's shapes: na=48 anchor columns
    # of Levenshtein-sized distances, a 1024-row band x 4096 columns
    na = 48
    D = rng.integers(0, 400, size=(nx, na)).astype(np.float32)
    Db, Dc = D[:1024], D[1024:1024 + 4096]
    rms = np.asarray(jax.jit(_band_score, static_argnums=2)(
        jnp.asarray(Db), jnp.asarray(Dc), "rms"
    ), dtype=np.float64)
    d64, c64 = Db.astype(np.float64), Dc.astype(np.float64)
    l2_want = ((d64[:, None, :] - c64[None, :, :]) ** 2).sum(axis=2)
    # f32 rounding of |a|^2 + |b|^2 - 2ab: a few ulps of the operands
    scale = (d64 ** 2).sum(1)[:, None] + (c64 ** 2).sum(1)[None, :]
    tol = 16 * np.finfo(np.float32).eps * scale
    err = np.abs(rms ** 2 * na - l2_want)
    log(f"   rms band score: max |err| / tol = {float((err / tol).max()):.3f}"
        " (tol = 16 f32 ulps of |a|^2+|b|^2)")
    assert (err <= tol).all(), "rms band score off its float64 reference"

    # cosine column of the fused max-min anchor program
    Xc = rng.standard_normal((nx, 64)).astype(np.float32)
    A, Dcos = _DenseBatchEngine("cosine").fused_maxmin(Xc, 8, 0)
    x64 = Xc.astype(np.float64)
    nrm = np.linalg.norm(x64, axis=1)
    want = 1.0 - (x64 @ x64[A].T) / (nrm[:, None] * nrm[A][None, :])
    cerr = float(np.abs(Dcos - want).max())
    log(f"   cosine columns: max |err| {cerr:.3e} (tol 1e-5)")
    assert cerr <= 1e-5, "cosine column off its float64 reference"


# ---------------------------------------------------------------------
# phase 2: headline fit, query, brute force


def mutate(s, n_sub, rng, alphabet="ACGT"):
    chars = list(s)
    for p in rng.choice(len(chars), size=n_sub, replace=False):
        chars[p] = rng.choice([c for c in alphabet if c != chars[p]])
    return "".join(chars)


def phase_headline(n=1600, length=500, n_queries=50, seed=42):
    import annchor_tpu as at
    from annchor_tpu.datasets import make_strings

    from annchor_tpu import native
    from annchor_tpu.ops.levenshtein import encode_strings

    X, _ = make_strings(n=n, length=length)
    X = list(X)
    k = 25
    t0 = time.perf_counter()
    bf = at.BruteForce(X, "levenshtein")
    bf.fit()
    log(f"   BruteForce: {time.perf_counter() - t0:.3f} s")
    # the ground truth itself, row by row, against the native DP
    codes, lengths = encode_strings(X)
    rows = np.random.default_rng(seed).choice(n, size=HEADLINE_GT_ROWS,
                                              replace=False)
    bf_d = np.asarray(bf.neighbor_graph[1])
    for r in rows:
        d = native.lev_batch(codes, lengths, np.full(n, r), np.arange(n))
        assert np.array_equal(np.sort(d)[: bf_d.shape[1]], bf_d[r]), r
    log(f"   BruteForce rows equal the native DP on {len(rows)} rows")
    t0 = time.perf_counter()
    ann = at.Annchor(X, "levenshtein", n_neighbors=k, p_work=0.12,
                     random_seed=42)
    ann.fit()
    fit_s = time.perf_counter() - t0
    errors = at.compare_neighbor_graphs(bf.neighbor_graph,
                                        ann.neighbor_graph, k)
    log(f"   Annchor fit: {fit_s:.3f} s (first call, compiles included), "
        f"evals {ann.evals}, errors {errors} (budget < "
        f"{HEADLINE_ERROR_BUDGET} for this stand-in set)")
    assert errors < HEADLINE_ERROR_BUDGET, "headline fit over its budget"

    rng = np.random.default_rng(seed)
    src = rng.choice(n, size=n_queries, replace=False)
    Q = [mutate(X[s], 5, rng) for s in src]
    t0 = time.perf_counter()
    qi, qd = ann.query(Q, nn=15, p_work=0.3)
    found = int((np.asarray(qi)[:, 0] == src).sum())
    log(f"   query: {time.perf_counter() - t0:.3f} s, "
        f"{found}/{n_queries} sources recovered")
    assert found == n_queries, "query did not recover every source"


# ---------------------------------------------------------------------
# phase 3: scale path


def scale_strings(n=SCALE_N, length=SCALE_LENGTH, seed=42):
    """benchmarks/scale_strings.py's corpus at its defaults."""
    from annchor_tpu.datasets import make_strings

    X, _ = make_strings(n=n, n_clusters=32, length=length,
                        mutation_rate=0.01, seed=seed, evolve=True)
    return list(X)


def distance_recall(ann, X, rows, R, k):
    from collections import Counter

    ngi = np.asarray(ann.neighbor_graph[0])
    hits = total = 0
    for t, r in enumerate(rows):
        d = R[t].copy()
        d[r] = np.inf
        exact = np.argsort(d, kind="stable")[: k - 1]
        got = ngi[r, 1:k]
        diff = Counter(np.sort(d[exact]).tolist()) - Counter(
            np.sort(d[got]).tolist()
        )
        hits += (k - 1) - sum(diff.values())
        total += k - 1
    return hits / total


def phase_scale(n=SCALE_N, length=SCALE_LENGTH, check_rows=SCALE_CHECK_ROWS):
    import jax

    import annchor_tpu as at

    X = scale_strings(n, length)
    rows = np.random.default_rng(0).choice(n, size=check_rows,
                                           replace=False)
    R = at.exact_rows(X, "levenshtein", rows=rows, block=32)
    t0 = time.perf_counter()
    ann = at.Annchor(X, "levenshtein", n_neighbors=SCALE_K,
                     p_work=SCALE_P_WORK)
    ann.fit()
    fit_s = time.perf_counter() - t0
    assert ann._dev is not None and ann._dev.sparse, "not the sparse path"
    assert ann._pair_build == "device-budgeted", ann._pair_build
    rec = distance_recall(ann, X, rows, R, SCALE_K)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"   scale fit n={n}: {fit_s:.3f} s (compiles included), evals "
        f"{ann.evals}, distance-recall {rec:.4f} over {check_rows} exact "
        f"rows, peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    assert np.isfinite(rec) and rec > 0.9, "scale recall collapsed"


# ---------------------------------------------------------------------
# phase 4: Wasserstein scout/certify hybrid


def phase_wasserstein(seed=0):
    import annchor_tpu as at
    from annchor_tpu import native
    from annchor_tpu.datasets import grid_cost_matrix

    H = digit_histograms(seed=seed)
    M = grid_cost_matrix(8, 8)
    t0 = time.perf_counter()
    ann = at.Annchor(H, "wasserstein",
                     func_kwargs={"cost_matrix": M, "scout": "sinkhorn"},
                     n_anchors=25, n_neighbors=25, n_samples=5000,
                     p_work=0.16, random_seed=42)
    ann.fit()
    ngi, ngd = (np.asarray(a) for a in ann.neighbor_graph)
    I = np.repeat(np.arange(ngi.shape[0]), ngi.shape[1])
    J = ngi.reshape(-1)
    # the solver's rounding depends on the pair's orientation, so an
    # edge must equal its exact EMD bit for bit in one orientation
    got = ngd.reshape(-1)
    bad = int(((native.emd_batch(H, H, M, I, J) != got)
               & (native.emd_batch(H, H, M, J, I) != got)).sum())
    log(f"   hybrid fit: {time.perf_counter() - t0:.3f} s, evals "
        f"{ann.evals}, {bad} of {I.shape[0]} edges differ from native EMD")
    assert bad == 0, "a reported edge is not its certified exact EMD"


# ---------------------------------------------------------------------
# four cards: the sharded scale fit against the one-card fit


def phase_four_cards(n=SCALE_N, length=SCALE_LENGTH,
                     pair_cap=FOUR_CARD_PAIR_CAP, devices=None):
    import jax

    import annchor_tpu as at

    devices = devices or jax.devices()
    X = scale_strings(n, length)
    kw = dict(n_neighbors=SCALE_K, p_work=SCALE_P_WORK, pair_cap=pair_cap,
              random_seed=42)
    os.environ["ANNCHOR_TPU_DISABLE_SHARDING"] = "1"
    try:
        t0 = time.perf_counter()
        one = at.Annchor(X, "levenshtein", **kw)
        one.fit()
        log(f"   one-card fit: {time.perf_counter() - t0:.3f} s")
    finally:
        os.environ.pop("ANNCHOR_TPU_DISABLE_SHARDING", None)
    t0 = time.perf_counter()
    four = at.Annchor(X, "levenshtein", **kw)
    four.fit()
    log(f"   {len(devices)}-card fit: {time.perf_counter() - t0:.3f} s")
    dev = four._dev
    assert dev.shard is not None, "fit state not sharded"
    shards = len(dev.RA.addressable_shards)
    log(f"   pair state shards: {shards}")
    assert shards == len(devices), "pair state not one shard per card"
    same = True
    for name, a, b in (("indices", one.neighbor_graph[0],
                        four.neighbor_graph[0]),
                       ("distances", one.neighbor_graph[1],
                        four.neighbor_graph[1])):
        a, b = np.asarray(a), np.asarray(b)
        diff = a != b
        if diff.any():
            same = False
            gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
            log(f"   {name} differ in {int(diff.sum())} of {a.size} "
                f"entries ({int(diff.any(axis=1).sum())} rows), max "
                f"|diff| {float(gap.max()):g}")
    errors = at.compare_neighbor_graphs(one.neighbor_graph,
                                        four.neighbor_graph, SCALE_K)
    log(f"   evals one-card {one.evals}, four-card {four.evals}; "
        f"compare_neighbor_graphs errors {errors}")
    assert same, "sharded fit diverged from the one-card fit"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded fit over four cards")
    args = ap.parse_args(argv)

    import annchor_tpu  # noqa: F401  (fails outside the repository)

    log(nvidia_smi_line())
    import jax

    devices = require_gpu(jax.devices(), 4 if args.four_cards else None)
    log(f"devices: {[d.device_kind for d in devices]}")
    # a fresh dataset cache inside the checkout's git-ignored .cache:
    # no ground truth left on disk is read
    cache_root = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".cache"
    )
    os.makedirs(cache_root, exist_ok=True)
    os.environ["ANNCHOR_TPU_CACHE"] = tempfile.mkdtemp(
        prefix="smoke-data-", dir=cache_root
    )
    if args.four_cards:
        with Phase("four-cards"):
            phase_four_cards(devices=devices[:4])
        print(result_line(devices[:4]))
        return 0
    with Phase("1 kernels: strings"):
        phase_kernels_strings()
    with Phase("1 kernels: dense"):
        phase_kernels_dense()
    with Phase("2 headline"):
        phase_headline()
    with Phase("3 scale"):
        phase_scale()
    with Phase("4 wasserstein"):
        phase_wasserstein()
    print(result_line(devices[:1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
