"""Digits-1797 / exact-Wasserstein k-NN graph benchmark.

Reference numbers (BASELINE.md, reference doc/user_guide.rst:208-209):
ANNchor with the exact kantorovich metric builds the k=25 graph at
p_work=0.16 in 21.311 s with 8 incorrect pairs (CI budget: error < 10,
reference tests/test_annchor.py:35-68).

The device-native configuration here is the scout/certify hybrid: an
exp-domain Sinkhorn engine on the device drives anchor selection and
refinement, and the exact native network-simplex solver certifies the
final (deduplicated) candidate edges — a few percent of the brute-force
exact-call budget.  Errors are counted against the exact ground-truth
graph, so the entropic approximation cannot hide mistakes.

Prints one JSON line.  Run `--exact` for the pure exact-metric
configuration (reference parity, slower).
"""

from __future__ import annotations

import json
import os
import sys
import time


import numpy as np  # noqa: E402

BASELINE_S = 21.311  # reference doc/user_guide.rst:208
BASELINE_ERRORS = 8
ERROR_BUDGET = 10  # reference CI, tests/test_annchor.py:65-68


def main(exact: bool = False, verbose: bool = False,
         refine_frac: float = 0.0):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import annchor_tpu as at
    from annchor_tpu.datasets import load_digits

    data = load_digits()
    X = data["X"]
    gt = data["neighbor_graph"]
    M = data["cost_matrix"]
    k = 25

    func_kwargs = {"cost_matrix": M}
    if not exact:
        func_kwargs["scout"] = "sinkhorn"

    kwargs = dict(
        func="wasserstein",
        func_kwargs=func_kwargs,
        n_anchors=25,
        n_neighbors=k,
        n_samples=5000,
        p_work=0.16,
        random_seed=42,
        verbose=verbose,
    )
    if refine_frac:
        # exact-metric protocol: hold back a share of p_work for
        # post-fit graph expansion (same total budget; measured
        # errors 4 -> 2 at 0.1 on the CPU backend, round 5)
        kwargs["refine_frac"] = refine_frac

    # Instrument the serial host EMD: cumulative seconds spent inside
    # native.emd_batch per fit, so the JSON line decomposes the wall
    # time into (host EMD) + (device programs + trips).  The wrapper
    # adds one perf_counter pair per batch call — noise, not cost.
    from annchor_tpu import native

    _emd_orig = native.emd_batch
    emd_stats = {"t": 0.0, "n": 0}

    def _emd_timed(Xa, Za, Mc, I, J):
        t0 = time.perf_counter()
        out = _emd_orig(Xa, Za, Mc, I, J)
        emd_stats["t"] += time.perf_counter() - t0
        emd_stats["n"] += len(I)
        return out

    native.emd_batch = _emd_timed

    def build():
        emd_stats["t"] = 0.0
        emd_stats["n"] = 0
        ann = at.Annchor(X, **kwargs)
        t0 = time.perf_counter()
        ann.fit()
        return ann, time.perf_counter() - t0, emd_stats["t"], emd_stats["n"]

    _, warm_s, _, _ = build()  # compile warm-up (numba JIT analogue)

    # In-session EMD microbench: the same native batch on random pairs
    # with the device idle; a number materially above the standalone
    # one is host-core contention, not the solver.
    rng = np.random.default_rng(0)
    mb = 50_000
    I = rng.integers(0, len(X), mb)
    J = rng.integers(0, len(X), mb)
    Xc = np.ascontiguousarray(X, np.float64)
    Mc = np.ascontiguousarray(M, np.float64)
    _emd_orig(Xc, Xc, Mc, I[:1000], J[:1000])  # touch caches
    t0 = time.perf_counter()
    _emd_orig(Xc, Xc, Mc, I, J)
    emd_us_idle = 1e6 * (time.perf_counter() - t0) / mb

    # best-of-4, like bench.py (its statistic is the benchmark PR's
    # to settle)
    runs = [build() for _ in range(4)]
    dt = min(r[1] for r in runs)
    best = min(runs, key=lambda r: r[1])
    errors = max(
        at.compare_neighbor_graphs(r[0].neighbor_graph, gt, k)
        for r in runs
    )
    ann = runs[-1][0]

    result = {
        "metric": "digits1797_wasserstein_build_s",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(dt / BASELINE_S, 4),
        "errors": int(errors),
        "error_budget": ERROR_BUDGET,
        "baseline_errors": BASELINE_ERRORS,
        "baseline_s": BASELINE_S,
        "warmup_s": round(warm_s, 3),
        "exact_evals": int(ann.evals),
        "scout_evals": int(ann.scout_evals),
        "mode": "exact" if exact else "sinkhorn_scout+exact_certify",
        "refine_frac": refine_frac,
        "p_work": kwargs["p_work"],
        "n": len(X),
        "emd_host_s": round(best[2], 3),
        "emd_host_calls": int(best[3]),
        "emd_us_idle": round(emd_us_idle, 1),
    }
    print(json.dumps(result))
    return 0 if errors < ERROR_BUDGET else 1


if __name__ == "__main__":
    rf = 0.0
    for a in sys.argv[1:]:
        if a.startswith("--refine-frac="):
            rf = float(a.split("=", 1)[1])
    sys.exit(main(
        exact="--exact" in sys.argv[1:],
        verbose="--verbose" in sys.argv[1:],
        refine_frac=rf,
    ))
