"""Kernel-level measurements on the GPU.

  --lev       Myers pair tiers (xla, triton) on device-resident pair
              ids at each string length in --lengths; the Triton tier
              is checked against the XLA one.
  --sinkhorn  Exp-domain Sinkhorn scout at 64 bins: the shipped
              full-f32 (HIGHEST) matvecs against the same loop at the
              default (TF32) precision, with the values' drift.
  --maxmin    Fused greedy max-min anchor program on the Myers
              encoding (the scale fits' anchor stage).
  --fits      The headline and 20k-string fits end to end with each
              Myers pair tier (``pair_kernel`` xla / triton), each fit
              run twice so the second excludes compilation.

Times are medians of --reps runs ending in jax.block_until_ready.  Each
section prints one JSON line per measurement and appends it to
$ANNCHOR_BENCH_OUT/kernels.jsonl (default: bench_out/ in the
repository).  Every line names the device; a run that
finds no GPU fails.

    python benchmarks/bench_kernels.py --lev --sinkhorn --fits
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RESULTS = os.path.join(
    os.environ.get("ANNCHOR_BENCH_OUT", os.path.join(ROOT, "bench_out")),
    "kernels.jsonl",
)


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "a") as fh:
        fh.write(line + "\n")


def _median_of(fn, k=5):
    ts = []
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench_kernels needs a GPU, found {dev.platform}")
    return dev.device_kind


def bench_lev(args):
    import jax
    import jax.numpy as jnp

    from annchor_tpu.datasets import make_strings
    from annchor_tpu.ops import levenshtein as lev_ops
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding, myers_pairs_dev,
    )

    B = args.pairs
    for length in [int(s) for s in args.lengths.split(",")]:
        n = args.n if length <= 600 else 2000
        X, _ = make_strings(n=n, length=length, seed=7)
        codes, lengths = lev_ops.encode_strings(list(X))
        enc = MyersEncoding.from_codes(codes, lengths)
        rng = np.random.default_rng(0)
        Ih = rng.integers(n, size=B).astype(np.int32)
        Jh = rng.integers(n, size=B).astype(np.int32)
        la = np.minimum(enc.lengths[Ih], enc.lengths[Jh]).astype(np.float64)
        lb = np.maximum(enc.lengths[Ih], enc.lengths[Jh])
        cells = float((la * lb).sum())
        I, J = jnp.asarray(Ih), jnp.asarray(Jh)
        tiers = {
            kernel: functools.partial(myers_pairs_dev, enc, I, J,
                                      kernel=kernel)
            for kernel in ("xla", "triton")
        }
        ref = None
        rec = {
            "bench": "levenshtein_pairs", "device": _device(),
            "n": n, "length": length, "pairs": B, "W_words": int(enc.W),
            "cells": cells,
        }
        for name, fn in tiers.items():
            t0 = time.perf_counter()
            d = np.asarray(jax.block_until_ready(fn()))
            rec[f"{name}_compile_s"] = time.perf_counter() - t0
            if ref is None:
                ref = d
            rec[f"{name}_matches"] = bool(np.array_equal(d, ref))
            t = _median_of(lambda: jax.block_until_ready(fn()), args.reps)
            rec[f"{name}_s"] = t
            rec[f"{name}_gcups"] = cells / t / 1e9
        emit(rec)


def bench_sinkhorn(args):
    import jax
    import jax.numpy as jnp

    from annchor_tpu.datasets import grid_cost_matrix
    from annchor_tpu.ops.wasserstein import TINY, SinkhornExpEngine

    M = grid_cost_matrix(8, 8)
    eng = SinkhornExpEngine(M)
    rng = np.random.default_rng(1)
    H = rng.gamma(1.0, size=(1797, 64))
    Xn = jnp.asarray((H / H.sum(1, keepdims=True)).astype(np.float32))
    B = args.pairs
    I = jnp.asarray(rng.integers(1797, size=B).astype(np.int32))
    J = jnp.asarray(rng.integers(1797, size=B).astype(np.int32))

    def scout(precision):
        mm = functools.partial(jnp.matmul, precision=precision)

        @jax.jit
        def run(I, J):  # ops/wasserstein._sinkhorn_exp_chunk
            A, Bh = jnp.take(Xn, I, axis=0), jnp.take(Xn, J, axis=0)
            K, KC = eng._Kd, eng._KCd

            def body(_, v):
                u = A / jnp.maximum(mm(v, K.T), TINY)
                return Bh / jnp.maximum(mm(u, K), TINY)

            v = jax.lax.fori_loop(0, eng.n_iter, body, jnp.ones_like(Bh))
            u = A / jnp.maximum(mm(v, K.T), TINY)
            return jnp.sum(u * mm(v, KC.T), axis=1)

        return run

    rec = {"bench": "sinkhorn_scout", "device": _device(), "pairs": B,
           "d": 64, "n_iter": eng.n_iter}
    vals = {}
    for name, prec in (("highest", jax.lax.Precision.HIGHEST),
                       ("default", jax.lax.Precision.DEFAULT)):
        fn = scout(prec)
        vals[name] = np.asarray(jax.block_until_ready(fn(I, J)))
        rec[f"{name}_s"] = _median_of(
            lambda: jax.block_until_ready(fn(I, J)), args.reps
        )
    rec["highest_over_default"] = rec["highest_s"] / rec["default_s"]
    rec["default_max_rel_drift"] = float(np.max(
        np.abs(vals["default"] - vals["highest"]) / vals["highest"]
    ))
    emit(rec)


def bench_maxmin(args):
    from annchor_tpu.datasets import make_strings
    from annchor_tpu.ops import levenshtein as lev_ops
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding, myers_maxmin,
    )

    n = args.n
    X, _ = make_strings(n=n, length=400, seed=7)
    codes, lengths = lev_ops.encode_strings(list(X))
    enc = MyersEncoding.from_codes(codes, lengths)
    na = 16
    myers_maxmin(enc, na=na, first_ix=0)  # compile
    t = _median_of(lambda: myers_maxmin(enc, na=na, first_ix=0), args.reps)
    emit({
        "bench": "myers_fused_maxmin", "device": _device(),
        "n": n, "length": 400, "na": na, "W_words": int(enc.W),
        "s": t, "s_per_anchor": t / na,
    })


def bench_fits(args):
    import annchor_tpu as at
    from annchor_tpu.datasets import make_strings

    X1, _ = make_strings()
    X2, _ = make_strings(n=20000, n_clusters=32, length=400,
                         mutation_rate=0.01, seed=42, evolve=True)
    fits = {
        "headline_1600": (list(X1), dict(n_neighbors=25, p_work=0.12,
                                         random_seed=42)),
        "scale_20k": (list(X2), dict(n_neighbors=15, p_work=0.01,
                                     random_seed=42)),
    }
    kind = _device()
    for name, (X, kw) in fits.items():
        for kernel in ("xla", "triton", "triton", "xla"):
            walls = []
            for _ in range(2):  # the first run compiles
                ann = at.Annchor(X, "levenshtein",
                                 func_kwargs={"pair_kernel": kernel}, **kw)
                t0 = time.perf_counter()
                ann.fit()
                walls.append(time.perf_counter() - t0)
            emit({
                "bench": "fit", "device": kind, "fit": name,
                "pair_kernel": kernel, "first_s": walls[0],
                "second_s": walls[1], "evals": int(ann.evals),
            })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lev", action="store_true")
    ap.add_argument("--sinkhorn", action="store_true")
    ap.add_argument("--maxmin", action="store_true")
    ap.add_argument("--fits", action="store_true")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--lengths", default="400,600")
    ap.add_argument("--pairs", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.lev:
        bench_lev(args)
    if args.sinkhorn:
        bench_sinkhorn(args)
    if args.maxmin:
        bench_maxmin(args)
    if args.fits:
        bench_fits(args)


if __name__ == "__main__":
    main()
