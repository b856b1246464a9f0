"""Out-of-sample query sweep on a saved scale-path index.

Loads the 20k budget-capped index the scale bench saved
(`scale_strings.py --save`), regenerates the identical corpus +
held-out queries, and sweeps the query budget (`p_work`) and the
query-side filter override (`loc_thresh`/`locality`, the round-10
extension) measuring full-population recall against exact query rows.

Answers VERDICT r3 #7's follow-up: is the 20k query recall
budget-limited (rises with p_work) or coverage-limited (rises with
the override at fixed budget)?

Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".cache")

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", type=str,
                    default=os.path.join(CACHE, "annchor_20k.npz"))
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--length", type=int, default=400)
    ap.add_argument("--clusters", type=int, default=32)
    ap.add_argument("--mutation-rate", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=15)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument(
        "--quick", action="store_true",
        help="only the two headline configs (tie-ceiling re-measure)",
    )
    args = ap.parse_args(argv)

    import annchor_tpu as at
    from annchor_tpu.datasets import make_strings

    X, _ = make_strings(
        n=args.n + args.nq,
        n_clusters=args.clusters,
        length=args.length,
        mutation_rate=args.mutation_rate,
        seed=args.seed,
        evolve=True,
    )
    X = list(X)
    Q = X[args.n:]
    X = X[: args.n]

    ann = at.Annchor.load(args.index, X, "levenshtein")

    qgt_path = (
        f"{CACHE}/annchor_qgt_{args.n}_{args.nq}_{args.length}_"
        f"{args.clusters}_{args.seed}.npy"
    )
    os.makedirs(CACHE, exist_ok=True)
    if os.path.exists(qgt_path):
        rows_q = np.load(qgt_path)
    else:
        rows_q = at.exact_query_rows(X, Q, "levenshtein", verbose=True)
        np.save(qgt_path, rows_q)
    order = np.argsort(rows_q, axis=1, kind="stable")[:, : args.k]
    gtd = np.take_along_axis(rows_q, order, axis=1)

    # query-side tie ceiling (the fit side measured 12.5% of true
    # edges in k-boundary tie groups, ROADMAP.md): per query, c edges
    # tie at the kth distance with T >= c equidistant candidates in
    # the population — any c of the T are equally correct, so a
    # uniform pick among them id-misses at rate c/k * (1 - c/T).
    # Measured id-gaps must be read against this floor; the
    # reference's own error metric (distance multisets) is tie-blind.
    gtd_full = np.take_along_axis(
        rows_q, np.argsort(rows_q, axis=1, kind="stable"), axis=1
    )
    dk = gtd_full[:, args.k - 1]
    c = (np.abs(gtd_full[:, : args.k] - dk[:, None]) < 1e-9).sum(axis=1)
    T = (np.abs(rows_q - dk[:, None]) < 1e-9).sum(axis=1)
    tie_miss = float(np.mean(c * (1.0 - c / np.maximum(T, 1)) / args.k))
    print(json.dumps({
        "metric": "query_tie_ceiling", "value": round(1 - tie_miss, 4),
        "unit": "expected_id_recall_ceiling",
        "boundary_tie_edges_frac": round(float(np.mean(c / args.k)), 4),
        "n": args.n, "nq": args.nq, "k": args.k,
    }), flush=True)

    configs = [
        {"p_work": 0.05},
        {"p_work": 0.05, "loc_thresh": 2, "locality": 8},
        {"p_work": 0.1},
        {"p_work": 0.1, "loc_thresh": 2, "locality": 8},
        # round-5 expansion rework (triangle screen + per-query fair
        # share) and the new budget-split knobs: more of the budget on
        # the graph walk, more rounds to reach it
        {"p_work": 0.1, "loc_thresh": 2, "locality": 8,
         "seed_frac": 0.3, "expand_rounds": 6},
        {"p_work": 0.1, "seed_frac": 0.3, "expand_rounds": 6},
        {"p_work": 0.05, "loc_thresh": 2, "locality": 8,
         "seed_frac": 0.3, "expand_rounds": 6},
        {"p_work": 0.2},
    ]
    if args.quick:
        configs = [
            {"p_work": 0.1, "loc_thresh": 2, "locality": 8},
            {"p_work": 0.1},
        ]
    _ = ann.query(Q[:8], nn=args.k, p_work=0.05)  # warm compile
    for cfg in configs:
        t0 = time.perf_counter()
        qg = ann.query(Q, nn=args.k, **cfg)
        dt = time.perf_counter() - t0
        got = np.asarray(qg[0])[:, : args.k]
        hits = sum(
            len(set(order[t].tolist()) & set(got[t].tolist()))
            for t in range(len(Q))
        )
        q_err = at.compare_neighbor_graphs((order, gtd), qg, args.k)
        print(json.dumps({
            "metric": "query_sweep_recall",
            "value": round(hits / (len(Q) * args.k), 4),
            "unit": "recall",
            "distance_recall": round(1 - q_err / (len(Q) * args.k), 4),
            "n": args.n,
            "nq": len(Q),
            "k": args.k,
            "query_s": round(dt, 2),
            "query_errors": int(q_err),
            **cfg,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
