"""Graph shortest-path (800-vertex dijkstra) k-NN benchmark.

Reference numbers (BASELINE.md, reference doc/user_guide.rst:626-627):
ANNchor with a per-pair dijkstra closure builds the k=15 graph at
p_work=0.15 in 38.200 s with 2 incorrect pairs (CI budget error < 10,
reference tests/test_annchor.py:143-145).

Here the metric is the framework's batched GraphShortestPathMetric:
pair batches group by source into whole single-source dijkstra solves
(scipy C) with row caching, so the entire fit costs at most nx SSSP
solves instead of ~p_work*N partial ones.  Pass --closure to run the
reference-style per-pair Python closure through the same pipeline.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time


import numpy as np  # noqa: E402

BASELINE_S = 38.200  # reference doc/user_guide.rst:626
BASELINE_ERRORS = 2
ERROR_BUDGET = 10  # reference CI, tests/test_annchor.py:143-145


def main(closure: bool = False):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import annchor_tpu as at
    from annchor_tpu.datasets import load_graph_sp
    from annchor_tpu.graph_sp import (
        GraphShortestPathMetric,
        shortest_path_metric,
    )

    data = load_graph_sp()
    X = np.asarray(data["X"])
    gt = data["neighbor_graph"]
    A = data["A"]
    k = 15

    kwargs = dict(
        n_anchors=20,
        n_neighbors=k,
        random_seed=5,
        n_samples=5000,
        p_work=0.15,
    )

    def build():
        func = (
            shortest_path_metric(A)
            if closure
            else GraphShortestPathMetric(A)
        )
        ann = at.Annchor(X, func, **kwargs)
        t0 = time.perf_counter()
        ann.fit()
        return ann, time.perf_counter() - t0

    _, warm_s = build()
    runs = [build() for _ in range(2)]
    dt = min(r[1] for r in runs)
    errors = max(
        at.compare_neighbor_graphs(r[0].neighbor_graph, gt, k)
        for r in runs
    )
    ann = runs[-1][0]

    result = {
        "metric": "graphsp800_build_s",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(dt / BASELINE_S, 4),
        "errors": int(errors),
        "error_budget": ERROR_BUDGET,
        "baseline_errors": BASELINE_ERRORS,
        "baseline_s": BASELINE_S,
        "warmup_s": round(warm_s, 3),
        "evals": int(ann.evals),
        "mode": "per_pair_closure" if closure else "batched_sssp",
        "p_work": kwargs["p_work"],
        "n": len(X),
    }
    print(json.dumps(result))
    return 0 if errors < ERROR_BUDGET else 1


if __name__ == "__main__":
    sys.exit(main(closure="--closure" in sys.argv[1:]))
