"""Query-path scaling benchmark (VERDICT r1 next #9).

Fits the 1600-string Levenshtein index once, then queries batches of
nq = 500 / 2000 / 5000 mutated strings and reports wall time and
per-query time.  The candidate path is fully vectorised (flat
(db, query) pair layout, one nonzero per query block — see
ops/locality.query_candidates), so per-query cost must FALL as nq
grows (batching amortises dispatches): the pass criterion is
s/query at nq=5000 < s/query at nq=500.

Runs on the CPU backend by default so it can execute anywhere; pass
--device to use JAX's default device (the GPU).
"""

from __future__ import annotations

import json
import os
import sys
import time

if "--device" not in sys.argv:
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

import numpy as np  # noqa: E402


def main():
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    import jax

    if "--device" not in sys.argv:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])

    import annchor_tpu as at
    from annchor_tpu.datasets import load_strings

    data = load_strings()
    X = list(data["X"])
    ann = at.Annchor(
        X, "levenshtein", n_neighbors=15, p_work=0.12, random_seed=42
    )
    t0 = time.perf_counter()
    ann.fit()
    fit_s = time.perf_counter() - t0

    # queries: mutated copies of training strings (each recovers its
    # source as 1-NN, which doubles as a correctness check)
    rng = np.random.default_rng(7)
    nq_max = 5000
    src = rng.integers(0, len(X), size=nq_max)
    queries = []
    for s in src:
        chars = list(X[s])
        for pos in rng.integers(0, len(chars), size=8):
            chars[pos] = "ACGT"[rng.integers(4)]
        queries.append("".join(chars))

    ann.query(queries[:50], nn=15, p_work=0.1)  # compile warm-up
    points = []
    for nq in (500, 2000, 5000):
        t0 = time.perf_counter()
        ngi, _ = ann.query(queries[:nq], nn=15, p_work=0.1)
        dt = time.perf_counter() - t0
        hit = float(np.mean(ngi[:, 0] == src[:nq]))
        points.append(
            {
                "nq": nq,
                "s": round(dt, 3),
                "s_per_query": round(dt / nq, 5),
                "top1_recovery": round(hit, 4),
            }
        )
        print(json.dumps(points[-1]), flush=True)

    sublinear = points[-1]["s_per_query"] < points[0]["s_per_query"]
    result = {
        "metric": "query_scaling_s_per_query_nq5000",
        "value": points[-1]["s_per_query"],
        "unit": "s/query",
        "fit_s": round(fit_s, 3),
        "points": points,
        "sublinear": bool(sublinear),
    }
    print(json.dumps(result))
    return 0 if sublinear else 1


if __name__ == "__main__":
    sys.exit(main())
