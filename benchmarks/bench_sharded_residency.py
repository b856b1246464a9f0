"""Sharded-fit residency/coverage measurement (VERDICT r2 next #4).

Runs a forced-sparse fit at --n on the virtual CPU mesh twice —
single-device and sharded — and records:

  * per-shard pair-state residency (must be ~m_pad/s per chip: the
    multi-chip memory win),
  * tracked pairs + candidate coverage for the auto cap, which scales
    with the mesh (cap x s) so multi-chip buys coverage,
  * wall clock for both modes (NOTE: on a virtual mesh all s shards
    share one physical CPU, so sharded wall time measures overhead,
    not speedup — the residency and coverage columns are the claim).

Appends one JSON line to $ANNCHOR_BENCH_OUT/sharded_residency.jsonl
(default: bench_out/ in the repository).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python benchmarks/bench_sharded_residency.py --n 20000
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(
    os.environ.get(
        "ANNCHOR_BENCH_OUT",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench_out"),
    ),
    "sharded_residency.jsonl",
)


def run(n, sharded, seed=42):
    import annchor_tpu as at
    from sklearn.datasets import make_blobs

    X, y = make_blobs(
        n_samples=n, centers=16, n_features=6, random_state=7
    )
    if sharded:
        os.environ.pop("ANNCHOR_TPU_DISABLE_SHARDING", None)
    else:
        os.environ["ANNCHOR_TPU_DISABLE_SHARDING"] = "1"
    try:
        t0 = time.time()
        ann = at.Annchor(
            X, "euclidean", n_anchors=24, n_neighbors=10,
            n_samples=3000, p_work=0.01, random_seed=seed,
        )
        ann.fit()
        wall = time.time() - t0
    finally:
        os.environ.pop("ANNCHOR_TPU_DISABLE_SHARDING", None)
    dev = ann._dev
    m = dev.m
    shards = None
    if dev.shard is not None:
        sh = dev.RA.addressable_shards
        shards = [int(s.data.shape[0]) for s in sh]
    # sampled recall vs brute force on a row sample
    rng = np.random.default_rng(3)
    rows = rng.integers(0, n, size=200)
    D = np.linalg.norm(X[rows][:, None, :] - X[None, :, :], axis=2)
    true = np.argsort(D, axis=1)[:, :10]
    gi = ann.neighbor_graph[0][rows][:, :10]
    recall = np.mean(
        [len(set(gi[t]) & set(true[t])) / 10 for t in range(len(rows))]
    )
    return {
        "sharded": sharded, "n": n, "wall_s": round(wall, 2),
        "pairs_tracked": int(m), "shards": shards,
        "sampled_recall_200rows": round(float(recall), 4),
        "evals": int(ann.evals),
    }


def run_coverage(n, sharded, seed=42):
    """Derived-cap run (cap scales with the mesh): measures whether
    cap x s converts the multi-chip residency headroom into candidate
    coverage and recall — the claim Annchor._mesh_scale codes
    (VERDICT r4 next #7).  Returns recall + true-edge coverage of the
    tracked pair set over 200 sample rows."""
    import annchor_tpu as at

    # UNclustered data so anchor profiles separate neighbours weakly
    # and the derived cap BINDS coverage (clustered blobs measured
    # coverage 0.999 at the single-chip cap — nothing for the mesh
    # to buy; this config measures single-chip coverage ~0.72)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(n, 12)).astype(np.float64)
    if sharded:
        os.environ.pop("ANNCHOR_TPU_DISABLE_SHARDING", None)
    else:
        os.environ["ANNCHOR_TPU_DISABLE_SHARDING"] = "1"
    try:
        t0 = time.time()
        ann = at.Annchor(
            X, "euclidean", n_anchors=16, n_neighbors=10,
            n_samples=3000, p_work=0.012, random_seed=seed,
            locality=4, loc_thresh=1,
        )
        ann.fit()
        wall = time.time() - t0
        cap = ann._derived_pair_cap() if hasattr(
            ann, "_derived_pair_cap") else None
        rng = np.random.default_rng(3)
        rows = rng.integers(0, n, size=200)
        D = np.linalg.norm(X[rows][:, None, :] - X[None, :, :], axis=2)
        true = np.argsort(D, axis=1)[:, 1:11]
        gi = np.asarray(ann.neighbor_graph[0])[rows][:, 1:11]
        recall = np.mean([
            len(set(gi[t]) & set(true[t])) / 10
            for t in range(len(rows))
        ])
        # tracked-set coverage of the true edges for the sample rows
        IJ = np.asarray(ann.IJs)
        keys = np.sort(
            IJ[:, 0].astype(np.int64) * n + IJ[:, 1].astype(np.int64)
        )
        a = np.repeat(rows, 10).astype(np.int64)
        b = true.reshape(-1).astype(np.int64)
        k = np.minimum(a, b) * n + np.maximum(a, b)
        pos = np.clip(np.searchsorted(keys, k), 0, keys.shape[0] - 1)
        coverage = float(np.mean(keys[pos] == k))
        m = int(ann._ij_dev[2]) if ann._ij_dev is not None else len(IJ)
    finally:
        os.environ.pop("ANNCHOR_TPU_DISABLE_SHARDING", None)
    return {
        "sharded": sharded, "n": n, "wall_s": round(wall, 2),
        "pairs_tracked": int(m),
        "derived_cap": cap,
        "sampled_recall_200rows": round(float(recall), 4),
        "coverage_200rows": round(coverage, 4),
        "evals": int(ann.evals),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument(
        "--coverage", action="store_true",
        help="derived-cap coverage run (cap scales with the mesh)",
    )
    args = ap.parse_args()
    os.environ.setdefault("ANNCHOR_TPU_FORCE_SPARSE", "1")
    if args.coverage:
        print("single-device derived-cap run...", flush=True)
        single = run_coverage(args.n, sharded=False)
        print(json.dumps(single), flush=True)
        print("sharded derived-cap run...", flush=True)
        shard = run_coverage(args.n, sharded=True)
        print(json.dumps(shard), flush=True)
        rec = {
            "bench": "sharded_coverage",
            "n": args.n,
            "single": single,
            "sharded": shard,
        }
        line = json.dumps(rec)
        print(line)
        os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
        with open(RESULTS, "a") as fh:
            fh.write(line + "\n")
        return
    # Pin an EXPLICIT pair cap: the derived cap scales with the mesh
    # (cap x s — multi-chip buys candidate coverage), which on a
    # VIRTUAL mesh sharing one physical core means the sharded run
    # does s times the single-device compute and times out.  An
    # explicit cap never scales, so both runs track the same pair set
    # and the per-shard residency claim (~m_pad/s) is measured at
    # matched m.
    os.environ.setdefault("ANNCHOR_TPU_PAIR_CAP", "200")
    print("single-device run...", flush=True)
    single = run(args.n, sharded=False)
    print(json.dumps(single), flush=True)
    print("sharded run...", flush=True)
    shard = run(args.n, sharded=True)
    print(json.dumps(shard), flush=True)
    rec = {
        "bench": "sharded_residency",
        "n": args.n,
        "single": single,
        "sharded": shard,
        "per_shard_fraction": (
            round(max(shard["shards"]) / shard["pairs_tracked"], 4)
            if shard["shards"] else None
        ),
    }
    line = json.dumps(rec)
    print(line)
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "a") as fh:
        fh.write(line + "\n")


if __name__ == "__main__":
    main()
