"""Stage-level timing of the budgeted pair build's per-band kernels.

The two-pass budgeted build (`ops/locality.py:
candidate_pairs_device_budgeted`) was most of the 100k build wall
when last profiled.  This profiles each
per-band kernel at the real 100k band shape on synthetic anchor
features (no metric evals — D is random, the kernels only see the
(nx, na) feature matrix), so one run attributes the per-band cost.

Usage:  python benchmarks/profile_budget_build.py [--nx 100000]
Prints one JSON line per stage: {"stage": ..., "best_s": ...,
"per_band_est_s": ...}.
"""

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from annchor_tpu.ops import locality as L


def timed(fn, sync, warmup=1, reps=4):
    for _ in range(warmup):
        sync(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=100_000)
    ap.add_argument("--na", type=int, default=96)
    ap.add_argument("--locality", type=int, default=5)
    ap.add_argument("--loc-thresh", type=int, default=3)
    ap.add_argument("--cap", type=int, default=700)
    ap.add_argument("--nbins", type=int, default=256)
    ap.add_argument("--clusters", type=int, default=64)
    args = ap.parse_args()

    nx, na = args.nx, args.na
    rng = np.random.default_rng(0)
    # synthetic anchor-distance matrix with cluster structure so the
    # keep mask has realistic density (the 100k strings run admits
    # ~250M of 5e9 pairs => ~10M per 4096-row band)
    nc = args.clusters
    centers = rng.normal(size=(nc, na)).astype(np.float32) * 2.0
    D = (
        centers[rng.integers(0, nc, size=nx)]
        + rng.normal(size=(nx, na)).astype(np.float32)
    )
    D = np.abs(D)

    S, sid = L.anchor_membership(D, args.locality)
    eff = L.effective_thresholds(
        S, args.loc_thresh, 2, locality=args.locality
    )
    eff_j = jnp.asarray(eff)
    S = jnp.asarray(S)
    D32 = jnp.asarray(D, dtype=jnp.float32)

    nblk = 4096
    while nblk * nx > (1 << 31) - 1 and nblk > 256:
        nblk //= 2
    Sb = S[:nblk]
    eb = eff_j[:nblk]
    s0 = np.int32(0)

    results = {}

    def rec(stage, best):
        results[stage] = best
        print(json.dumps({"stage": stage, "best_s": round(best, 4)}),
              flush=True)

    # stage 1: count
    rec("block_keep_total", timed(
        lambda: L._block_keep_total(S, Sb, eb, eff_j, s0),
        lambda r: np.asarray(r[0]),
    ))
    t = int(L._block_keep_total(S, Sb, eb, eff_j, s0)[0])
    print(json.dumps({"band_pairs": t}), flush=True)
    cap = L._cap_bucket(t)

    # stage 2: extract
    rec("block_keep_extract", timed(
        lambda: L._block_keep_extract(S, Sb, eb, eff_j, s0, cap),
        lambda r: np.asarray(r[0][:1]),
    ))
    bi, bj = L._block_keep_extract(S, Sb, eb, eff_j, s0, cap)
    bi, bj = bi[:t], bj[:t]

    # stage 3: pair lower bounds
    rec("pairs_lb", timed(
        lambda: L._pairs_lb(D32, bi, bj),
        lambda r: np.asarray(r[:1]),
    ))
    lb = L._pairs_lb(D32, bi, bj)

    # stage 4: histogram scatter-add
    lb_max = float(D.max() * 2.0) + 1e-6
    inv_bin = np.float32(args.nbins / lb_max)
    hist0 = jnp.zeros((nx, args.nbins), dtype=jnp.int32)
    rec("hist_update", timed(
        lambda: L._hist_update(hist0, bi, bj, lb, inv_bin, args.nbins),
        lambda r: np.asarray(r[:1, :1]),
    ))

    # stage 5 (pass 2): threshold keep + compaction + counts
    hist = L._hist_update(hist0, bi, bj, lb, inv_bin, args.nbins)
    thr = L._hist_thresholds(
        hist, jnp.int32(args.cap), np.float32(lb_max / args.nbins),
        args.nbins,
    )
    keep = lb <= jnp.maximum(jnp.take(thr, bi), jnp.take(thr, bj))
    kept = int(jnp.sum(keep, dtype=jnp.int32))
    kcap = L._cap_bucket(max(kept, 1))
    rec("keep_counts", timed(
        lambda: L._keep_counts(keep, bi, bj, jnp.zeros(nx, jnp.int32)),
        lambda r: np.asarray(r[:1]),
    ))
    rec("compact_kept", timed(
        lambda: L._compact_kept(bi, bj, keep, kcap),
        lambda r: np.asarray(r[0][:1]),
    ))

    # ---- dense-band twins (same math, reductions only) ---------------
    cchunk = 2048
    nxp = ((nx + cchunk - 1) // cchunk) * cchunk
    Sp = jnp.asarray(
        np.pad(np.asarray(S, np.float32), ((0, nxp - nx), (0, 0)))
    )
    D32p = jnp.asarray(
        np.pad(np.asarray(D32), ((0, nxp - nx), (0, 0)))
    )
    effp = jnp.asarray(
        np.pad(np.asarray(eff, np.float32), (0, nxp - nx),
               constant_values=np.inf)
    )
    Sbp = Sp[:nblk]
    Dbp = D32p[:nblk]
    ebp = effp[:nblk]
    bin_w = np.float32(lb_max / args.nbins)

    rec("dense_bins", timed(
        lambda: L._band_bins_sym(
            D32p, Sp, Sbp, Dbp, ebp, effp, np.int32(0), inv_bin,
            args.nbins, cchunk,
        ),
        lambda r: np.asarray(r[:1, :1]),
    ))
    BINs = L._band_bins_sym(
        D32p, Sp, Sbp, Dbp, ebp, effp, np.int32(0), inv_bin,
        args.nbins, cchunk,
    )
    rec("dense_thr", timed(
        lambda: L._band_thr_from_bins(
            BINs, jnp.int32(args.cap), bin_w, args.nbins
        ),
        lambda r: np.asarray(r[:1]),
    ))
    thr_d = L._band_thr_from_bins(
        BINs, jnp.int32(args.cap), bin_w, args.nbins
    )
    thr_pad = jnp.concatenate([
        thr_d, jnp.full(nxp - nblk, np.inf, jnp.float32)
    ])
    rec("dense_keep2", timed(
        lambda: L._band_keep2_dense(
            D32p, Sp, Sbp, Dbp, ebp, effp, thr_pad, np.int32(0), cchunk
        ),
        lambda r: np.asarray(r[3]),
    ))
    keep2, rowcnt, colcnt, kept2 = L._band_keep2_dense(
        D32p, Sp, Sbp, Dbp, ebp, effp, thr_pad, np.int32(0), cchunk
    )
    kept2 = int(kept2)
    kcap2 = L._cap_bucket(max(kept2, 1))
    rec("dense_extract_flatnz", timed(
        lambda: L._extract_dense(keep2, np.int32(0), kcap2),
        lambda r: np.asarray(r[0][:1]),
    ))
    Kmax = int(np.asarray(rowcnt).max())
    K = max(128, 1 << max(Kmax - 1, 0).bit_length())
    print(json.dumps({"dense_kept": kept2, "row_kmax": Kmax,
                      "topk_K": K}), flush=True)
    rec("dense_extract_topk", timed(
        lambda: L._extract_dense_topk(keep2, np.int32(0), K, kcap2),
        lambda r: np.asarray(r[0][:1]),
    ))
    if K < 2048:  # the real 100k strings run reaches max_deg ~1721
        rec("dense_extract_topk_K2048", timed(
            lambda: L._extract_dense_topk(keep2, np.int32(0), 2048,
                                          kcap2),
            lambda r: np.asarray(r[0][:1]),
        ))

    nbands = (nx + nblk - 1) // nblk
    p1 = (results["block_keep_total"] + results["block_keep_extract"]
          + results["pairs_lb"] + results["hist_update"])
    p2 = (results["block_keep_extract"] + results["pairs_lb"]
          + results["keep_counts"] + results["compact_kept"])
    d1 = results["dense_bins"] + results["dense_thr"]
    d2 = results["dense_keep2"] + min(
        results["dense_extract_flatnz"], results["dense_extract_topk"]
    )
    print(json.dumps({
        "metric": "budget_build_band_profile",
        "nx": nx, "band_pairs": t, "kept": kept, "nbands": nbands,
        "pass1_band_s": round(p1, 3), "pass2_band_s": round(p2, 3),
        "est_total_s": round(nbands * (p1 + p2), 1),
        "dense_pass1_band_s": round(d1, 3),
        "dense_pass2_band_s": round(d2, 3),
        "dense_est_total_s": round(nbands * (d1 + d2), 1),
        "stages": {k: round(v, 4) for k, v in results.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
