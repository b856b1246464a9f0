"""Out-of-sample query benchmark (reference tests/test_examples.py:12-58).

Workload: digits train/test split (75/25), fit on the train set
(wasserstein, p_work=0.16), query the test set at p_work=0.2.
Reference CI budgets: 15-NN recall vs exact >= 0.99 and 1-NN label
accuracy >= 0.95 (no wall-clock number is published for the query
path, so the JSON reports ours without a vs_baseline ratio).

Default mode runs the scout/certify hybrid; recall is measured against
exact brute-force query distances, so the entropic scout cannot hide
mistakes.  ``--exact`` runs the reference's own protocol instead — an
exact-metric fit (plain "wasserstein", no scout) and plain exact
refinement, exactly as reference tests/test_examples.py:12-58 — over
the FULL test split (the reference samples 25 queries).
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import Counter


import numpy as np  # noqa: E402

RECALL_BUDGET = 0.99
ACC_BUDGET = 0.95


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sklearn.model_selection import train_test_split

    import annchor_tpu as at
    from annchor_tpu.datasets import load_digits

    exact = "--exact" in sys.argv

    data = load_digits()
    X, y, M = data["X"], data["y"], data["cost_matrix"]
    X_train, X_test, y_train, y_test = train_test_split(X, y, random_state=0)

    func_kwargs = {"cost_matrix": M}
    if not exact:
        func_kwargs["scout"] = "sinkhorn"
    ann = at.Annchor(
        X_train,
        "wasserstein",
        func_kwargs=func_kwargs,
        n_anchors=25,
        n_neighbors=25,
        n_samples=5000,
        p_work=0.16,
        random_seed=42,
    )
    t0 = time.perf_counter()
    ann.fit()
    fit_s = time.perf_counter() - t0

    # warm-up query (compiles the query-side kernels), then timed
    ann.query(X_test[:50], p_work=0.2)
    t0 = time.perf_counter()
    ngi, ngd = ann.query(X_test, p_work=0.2)
    query_s = time.perf_counter() - t0

    # recall vs exact 15-NN over the FULL query population (the
    # reference samples 25 queries, which is +-1.5% noise at this
    # threshold); the exact ground truth is cached after the first run
    from annchor_tpu import native
    from annchor_tpu.datasets import _cache_dir

    gt_path = os.path.join(_cache_dir(), "digits_query_gt15.npz")
    nq, nx = len(X_test), len(X_train)
    if os.path.exists(gt_path):
        gt15 = np.load(gt_path)["gt15"]
    else:
        Xc = np.ascontiguousarray(X_train, np.float64)
        Qc = np.ascontiguousarray(X_test, np.float64)
        Mc = np.ascontiguousarray(M, np.float64)
        I = np.tile(np.arange(nx), nq)
        J = np.repeat(np.arange(nq), nx)
        ds = native.emd_batch(Xc, Qc, Mc, I, J).reshape(nq, nx)
        gt15 = np.argsort(ds, axis=1, kind="stable")[:, :15]
        np.savez_compressed(gt_path, gt15=gt15)
    errs = sum(len(np.setdiff1d(gt15[i], ngi[i])) for i in range(nq))
    recall = 1 - errs / (15 * nq)

    y_pred = np.array(
        [Counter(y_train[row]).most_common(1)[0][0] for row in ngi]
    )
    acc = float(np.mean(y_pred == y_test))

    result = {
        "metric": "digits_query_s" + ("_exactfit" if exact else ""),
        "value": round(query_s, 3),
        "unit": "s",
        "fit_s": round(fit_s, 3),
        "recall15": round(recall, 4),
        "recall_budget": RECALL_BUDGET,
        "label_acc": round(acc, 4),
        "acc_budget": ACC_BUDGET,
        "nq": len(X_test),
        "mode": (
            "exact_fit" if exact else "sinkhorn_scout+exact_certify"
        ),
    }
    print(json.dumps(result))
    return 0 if (recall >= RECALL_BUDGET and acc >= ACC_BUDGET) else 1


if __name__ == "__main__":
    sys.exit(main())
