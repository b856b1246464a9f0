"""Build the k-NN graph of the bundled 1600-string set (Levenshtein).

The reference demonstrates this workload in its README (34.3 s on a
quad-core i5).

    python examples/strings_knn.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import annchor_tpu as at
from annchor_tpu.datasets import load_strings


def main():
    data = load_strings()
    X = data["X"]

    ann = at.Annchor(
        X,
        "levenshtein",
        n_anchors=23,
        n_neighbors=25,
        n_samples=5000,
        p_work=0.12,
        niters=4,
        verbose=True,
    )
    t0 = time.perf_counter()
    ann.fit()
    print(f"\nbuilt in {time.perf_counter() - t0:.1f}s "
          f"({ann.evals} metric calls, "
          f"{100 * ann.evals / ann.N:.1f}% of brute force)")

    err = at.compare_neighbor_graphs(
        ann.neighbor_graph, data["neighbor_graph"], 25
    )
    print(f"incorrect NN pairs vs exact ground truth: {err} / "
          f"{len(X) * 25}")

    # out-of-sample query: corrupted copies must recover their source
    Q = [s[:100] + s[103:] for s in X[:10]]
    qi, qd = ann.query(Q, nn=5, p_work=0.3)
    print("query self-recovery:", np.mean(qi[:, 0] == np.arange(10)))


if __name__ == "__main__":
    main()
