"""Headline benchmark: 1600-string Levenshtein k-NN graph build.

Reference numbers (BASELINE.md, reference README.md:115-116):
ANNchor builds the k=25 graph of the bundled 1600-string set at
p_work=0.12 in 34.299 s with 0 incorrect NN pairs (i5 MacBook Pro,
numba JIT compile time excluded).  This script runs the same workload
through annchor_tpu and prints ONE JSON line:

    {"metric": "strings1600_build_s", "value": <seconds>, "unit": "s",
     "vs_baseline": <seconds / 34.299>, ...}

vs_baseline < 1 means faster than the reference.  A warm-up fit first
triggers all XLA compilations (the analogue of the excluded numba JIT
compile), then the timed fit runs with every kernel cached.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_S = 34.299  # reference README.md:115
BASELINE_ERRORS = 0


def device_record():
    """The device this run measures: JAX's view plus nvidia-smi's name
    and power limit.  Anything but a GPU is an error."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX found {devices[0].platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "nvidia_smi": smi,
    }


def main():
    import annchor_tpu as at
    from annchor_tpu.datasets import load_strings

    device = device_record()
    data = load_strings()
    X = data["X"]
    gt = data["neighbor_graph"]
    k = 25

    # exactly the reference README benchmark invocation
    # (`Annchor(X, 'levenshtein', n_neighbors=25, p_work=0.12)`,
    # /root/reference/README.md:102 — every other knob at its default)
    kwargs = dict(
        func="levenshtein",
        n_neighbors=k,
        p_work=0.12,
        random_seed=42,
    )

    def build():
        ann = at.Annchor(X, **kwargs)
        t0 = time.perf_counter()
        ann.fit()
        dt = time.perf_counter() - t0
        return ann, dt

    # warm-up: compile every kernel (reference excludes numba JIT time,
    # BASELINE.md "First run excludes numba JIT compile time")
    _, warm_s = build()

    # best of eight timed runs (the statistic and the cell set are the
    # benchmark's to settle, ROADMAP A1)
    runs = [build() for _ in range(8)]
    dt = min(r[1] for r in runs)
    errors = max(
        at.compare_neighbor_graphs(r[0].neighbor_graph, gt, k)
        for r in runs
    )
    ann = runs[-1][0]

    result = {
        "metric": "strings1600_build_s",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(dt / BASELINE_S, 4),
        "errors": int(errors),
        "baseline_errors": BASELINE_ERRORS,
        "baseline_s": BASELINE_S,
        "warmup_s": round(warm_s, 3),
        "evals": int(ann.evals),
        "p_work": kwargs["p_work"],
        "n": len(X),
        **device,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
