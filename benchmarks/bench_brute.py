"""BruteForce parity rows: the reference publishes exact brute-force
baselines (strings-1600 Levenshtein 173.302 s, doc/user_guide.rst:387-388;
digits-1797 Wasserstein 108.233 s, :136-137) built over joblib processes.
This framework's BruteForce rides the same batched device engines as the
fit, so the exact graph itself is a benchmark row.

Protocol: one small warm-up batch primes the compile cache (the
reference likewise excludes numba JIT), then the full upper-triangle
build is timed.  Exactness is asserted against an Annchor fit's
0-error contract (strings) by comparing the graphs.

Appends one JSON line per dataset to $ANNCHOR_BENCH_OUT/bench_brute.jsonl
(default: bench_out/ in the repository).
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
    "bench_brute.jsonl",
)


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "a") as fh:
        fh.write(line + "\n")


def bench_strings():
    import jax

    import annchor_tpu as at
    from annchor_tpu.datasets import load_strings

    data = load_strings()
    X = data["X"]
    t0 = time.time()
    bf = at.BruteForce(X, "levenshtein")  # ctor smoke test warms compile
    # one representative batch to finish priming the chunk-size cache
    iu = np.stack(np.triu_indices(64, k=1), axis=1)
    bf.get_exact_ijs(bf.f, X, iu)
    warm = time.time() - t0

    t0 = time.time()
    bf.fit()
    wall = time.time() - t0

    # exactness cross-check vs the dataset's cached exact ground truth
    err = at.compare_neighbor_graphs(
        bf.neighbor_graph, data["neighbor_graph"], 25
    )
    emit({
        "metric": "bruteforce_strings_1600_s",
        "value": round(wall, 3), "unit": "s",
        "device": jax.devices()[0].device_kind,
        "warmup_s": round(warm, 2),
        "pairs": int(len(X) * (len(X) - 1) // 2),
        "errors_vs_exact_gt": int(err),
        "vs_baseline": round(wall / 173.302, 4),
    })


def bench_digits(large=False):
    """Exact-EMD BruteForce on the digits sets.  The reference's rows:
    digits-1797 108.233 s (doc/user_guide.rst:136-137) and PyNNDescent
    70.988 s (:173-174) on the same machine.  Here every pair goes
    through the native C++ network-simplex solver (~39 us/call,
    serial on the single host core) — the graph is exact by
    construction and doubles as a GT cross-check."""
    import jax

    import annchor_tpu as at

    if large:
        from annchor_tpu.datasets import load_digits_large as load
        name, base = "digits_large_5620", None
    else:
        from annchor_tpu.datasets import load_digits as load
        name, base = "digits_1797", 108.233
    data = load()
    X, M = data["X"], data["cost_matrix"]

    t0 = time.time()
    bf = at.BruteForce(X, "wasserstein", {"cost_matrix": M})
    warm = time.time() - t0  # ctor smoke test = 20 solver calls

    t0 = time.time()
    bf.fit()
    wall = time.time() - t0

    err = at.compare_neighbor_graphs(
        bf.neighbor_graph, data["neighbor_graph"], 25
    )
    rec = {
        "metric": f"bruteforce_{name}_s",
        "value": round(wall, 3), "unit": "s",
        "device": jax.devices()[0].device_kind,
        "warmup_s": round(warm, 2),
        "pairs": int(len(X) * (len(X) - 1) // 2),
        "errors_vs_exact_gt": int(err),
    }
    if base is not None:
        rec["vs_baseline"] = round(wall / base, 4)
    emit(rec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--strings", action="store_true")
    ap.add_argument("--digits", action="store_true")
    ap.add_argument("--digits-large", action="store_true")
    args = ap.parse_args()
    ran = False
    if args.strings:
        bench_strings()
        ran = True
    if args.digits:
        bench_digits()
        ran = True
    if args.digits_large:
        bench_digits(large=True)
        ran = True
    if not ran:
        ap.error("pick a dataset: --strings / --digits / --digits-large")


if __name__ == "__main__":
    main()
