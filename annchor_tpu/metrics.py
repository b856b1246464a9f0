"""Metric resolution and batched pairwise evaluation.

This is the accelerator re-design of the reference's L2 "metric-evaluation /
parallelisation backend" (reference annchor/utils.py:62-271).  The
reference fans scalar metric calls out over joblib worker processes or
numba thread teams; here every built-in metric has a *batched engine*
that evaluates whole pair blocks on the device (or, for the inherently
sequential exact optimal transport, in native C++ on the host), and
arbitrary user Python metrics fall back to a host loop — preserving the
reference's `get_exact_ijs(f, X, IJ)` plug-in contract
(reference annchor/annchor.py:77-82, doc/parallelisation.rst:14-32).
"""

from __future__ import annotations

import atexit

import numpy as np

from annchor_tpu.ops import levenshtein as _lev_ops

__all__ = [
    "Metric",
    "get_function_from_input",
    "make_get_exact_ijs",
    "make_get_exact_query_ijs",
    "test_parallelisation",
]


class Metric:
    """A metric plus (optionally) a batched pairwise engine.

    scalar: f(x, y) -> float, the user-visible metric
    batch:  optional fn(X, Z, IJ) -> float64 (m,) evaluating
            [f(X[i], Z[j]) for i, j in IJ] as one batch.  Z is X for
            in-sample pairs.  Engines may cache per-dataset encodings.
    is_metric: whether the triangle inequality is trusted
        (reference annchor.py:73-76).
    """

    scout: "object | None"

    def __init__(
        self, scalar, batch=None, name="custom", is_metric=True, scout=None
    ):
        self.scalar = scalar
        self.batch = batch
        self.name = name
        self.is_metric = is_metric
        # optional cheap approximate engine: when present, Annchor
        # explores with it and certifies the final graph edges with the
        # exact engine (scout/certify hybrid — see Annchor.get_ann)
        self.scout = scout

    def __call__(self, x, y):
        return self.scalar(x, y)


# ---------------------------------------------------------------------------
# built-in metrics


def _euclidean_scalar(x, y):
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y)))


def _cosine_scalar(x, y):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    nx = np.linalg.norm(x)
    ny = np.linalg.norm(y)
    if nx == 0 or ny == 0:
        return 0.0
    return float(1.0 - np.dot(x, y) / (nx * ny))


class _DenseBatchEngine:
    """Batched vector-metric engine (euclidean / cosine / sqeuclidean).

    Gathers pair rows on device and reduces — replaces the reference's
    numba prange loop (utils.py:144-150).
    """

    def __init__(self, kind: str, chunk: int = 1 << 20):
        self.kind = kind
        self.chunk = chunk
        self._jit = None
        self._sharded = {}
        self._dev_cache = {}  # up to two datasets (fit X + query Q)

    def _raw_kernel(self):
        import jax.numpy as jnp

        kind = self.kind

        def kern(X, Z, I, J):
            a = jnp.take(X, I, axis=0)
            b = jnp.take(Z, J, axis=0)
            if kind == "euclidean":
                return jnp.sqrt(jnp.sum((a - b) ** 2, axis=1))
            if kind == "sqeuclidean":
                return jnp.sum((a - b) ** 2, axis=1)
            if kind == "cosine":
                num = jnp.sum(a * b, axis=1)
                den = jnp.linalg.norm(a, axis=1) * jnp.linalg.norm(
                    b, axis=1
                )
                return 1.0 - num / jnp.maximum(den, 1e-30)
            raise ValueError(kind)

        return kern

    def _kernel(self):
        if self._jit is None:
            import jax

            self._jit = jax.jit(self._raw_kernel())
        return self._jit

    def _kernel_for(self, mesh):
        """Mesh-sharded variant: dataset replicated, pairs split
        (SURVEY.md §2.2)."""
        if mesh is None:
            return self._kernel()
        if mesh not in self._sharded:
            import jax
            from jax.sharding import PartitionSpec as P

            self._sharded[mesh] = jax.jit(
                jax.shard_map(
                    self._raw_kernel(),
                    mesh=mesh,
                    in_specs=(P(), P(), P("pairs"), P("pairs")),
                    out_specs=P("pairs"),
                    check_vma=False,
                )
            )
        return self._sharded[mesh]

    def __call__(self, X, Z, IJ):
        import jax.numpy as jnp

        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        Xd = self._data_dev(X)  # repeated calls reuse the upload
        Zd = Xd if Z is X else self._data_dev(Z)

        from annchor_tpu import parallel

        mesh = parallel.auto_mesh()
        # async dispatch per chunk, one download at the end (no
        # per-chunk host wait)
        outs = []
        for s in range(0, IJ.shape[0], self.chunk):
            blk = IJ[s : s + self.chunk]
            m_blk = mesh
            pad = 0
            if m_blk is not None:
                pad = (-blk.shape[0]) % m_blk.size
                if pad:
                    blk = np.concatenate([blk, blk[-1:].repeat(pad, 0)])
            kern = self._kernel_for(m_blk)
            d = kern(Xd, Zd, jnp.asarray(blk[:, 0]), jnp.asarray(blk[:, 1]))
            outs.append(d[: d.shape[0] - pad] if pad else d)
        if len(outs) == 1:
            return np.asarray(outs[0]).astype(np.float64)
        return np.asarray(jnp.concatenate(outs)).astype(np.float64)

    def _data_dev(self, X):
        hit = self._dev_cache.get(id(X))
        if hit is not None and hit[0] is X:
            # LRU touch: move to the end so a steady fit-side X is
            # never the one evicted by a stream of query batches
            self._dev_cache.pop(id(X))
            self._dev_cache[id(X)] = hit
            return hit[1]
        import jax.numpy as jnp

        Xd = jnp.asarray(np.asarray(X), dtype=jnp.float32)
        if len(self._dev_cache) >= 2:  # bound pinned device memory
            # evict only the least-recently-used entry (ADVICE r4:
            # clearing both dropped the fitted X's device buffer on a
            # second distinct query batch, forcing a full re-upload)
            self._dev_cache.pop(next(iter(self._dev_cache)))
        self._dev_cache[id(X)] = (X, Xd)  # strong ref pins id(X)
        return Xd

    def batch_dev_ready(self, X):
        return True

    def batch_dev(self, X, I, J):
        """Device-id eval: I, J int32 device arrays -> device f32
        distances, no host hop (lets the fit pipeline chain
        select -> eval -> scatter in one dispatch sequence).  Chunked
        into bounded async dispatches; nothing blocks."""
        import jax.numpy as jnp

        Xd = self._data_dev(X)
        kern = self._kernel()
        B = I.shape[0]
        if B <= self.chunk:
            return kern(Xd, Xd, I, J)
        outs = [
            kern(Xd, Xd, I[s : s + self.chunk], J[s : s + self.chunk])
            for s in range(0, B, self.chunk)
        ]
        return jnp.concatenate(outs)

    def fused_maxmin(self, X, na, first_ix, verbose=False):
        """Whole greedy max-min anchor loop as one device program
        (see ops/levenshtein_myers.myers_maxmin for the pattern;
        replaces na host round-trips, reference pickers.py:18-52)."""
        import functools

        import jax
        import jax.numpy as jnp

        kind = self.kind

        @functools.partial(jax.jit, static_argnames=("na",))
        def run(Xd, first, na):
            n = Xd.shape[0]
            row_ids = jnp.arange(na, dtype=jnp.int32)

            def body(i, carry):
                D, A, ix = carry
                col = _dense_column(Xd, jnp.take(Xd, ix, axis=0), kind)
                D = jax.lax.dynamic_update_slice_in_dim(
                    D, col[None, :], i, axis=0
                )
                A = A.at[i].set(ix)
                # reference quirk: running min excludes the first
                # anchor's column (pickers.py:48-50 uses D[1:])
                live = (row_ids >= 1) & (row_ids <= i)
                minD = jnp.min(
                    jnp.where(live[:, None], D, jnp.float32(np.inf)),
                    axis=0,
                )
                nxt = jnp.where(i == 0, jnp.argmax(col), jnp.argmax(minD))
                return D, A, nxt.astype(jnp.int32)

            D0 = jnp.zeros((na, n), dtype=jnp.float32)
            A0 = jnp.zeros((na,), dtype=jnp.int32)
            D, A, _ = jax.lax.fori_loop(
                0, na, body, (D0, A0, jnp.asarray(first, jnp.int32))
            )
            return A, D

        Xd = jnp.asarray(np.asarray(X), dtype=jnp.float32)
        A, D = run(Xd, int(first_ix), int(na))
        return np.asarray(A), np.asarray(D, dtype=np.float64).T


def _dense_column(Xd, x, kind: str):
    """Distances from one vector x to every row of Xd."""
    import jax
    import jax.numpy as jnp

    if kind == "euclidean":
        return jnp.sqrt(jnp.sum((Xd - x) ** 2, axis=1))
    if kind == "sqeuclidean":
        return jnp.sum((Xd - x) ** 2, axis=1)
    # full f32: TF32 would misrank near-parallel vectors
    num = jnp.matmul(Xd, x, precision=jax.lax.Precision.HIGHEST)
    den = jnp.linalg.norm(Xd, axis=1) * jnp.linalg.norm(x)
    return 1.0 - num / jnp.maximum(den, 1e-30)


def _adaptive_block(m: int, max_block: int) -> int:
    """Smallest power-of-two block >= m, capped at max_block.

    Keeps the number of compiled kernel variants tiny while avoiding
    the 5x padding waste of always padding small batches (e.g. the
    1600-pair anchor columns) up to the full block size."""
    b = 1024
    while b < m and b < max_block:
        b <<= 1
    return b


class _LevenshteinEngine:
    """Batched device edit distance with per-dataset encoding cache.

    Uses the bit-parallel Myers kernels (ops/levenshtein_myers.py) when
    the dataset alphabet is small enough, and the row-DP kernel
    (ops/levenshtein.py) otherwise.  Pair batches go to one of two
    Myers tiers (``pair_kernel``): ``"xla"`` or the GPU kernel
    ``"triton"`` (ops/levenshtein_triton.py).  ``None`` picks the GPU
    kernel on a GPU for the patterns it serves (``levenshtein_triton.
    serves``: where it measured faster), and XLA everywhere else.  ``interpret=True`` runs the GPU kernel
    through the Pallas interpreter (tests only).  All of these replace
    the reference's per-pair C-extension calls (reference
    annchor/distances.py:16-20, utils.py:144-177)."""

    def __init__(self, block_size: int = 32768, use_myers: bool = True,
                 pair_kernel=None, interpret: bool = False):
        if pair_kernel not in (None, "xla", "triton"):
            raise ValueError(
                "pair_kernel must be None, 'xla' or 'triton', got "
                f"{pair_kernel!r}"
            )
        self.block_size = block_size
        self.use_myers = use_myers
        self.pair_kernel = pair_kernel
        self.interpret = interpret
        self.dev_chunk = 1 << 16  # batch_dev dispatch bound (device temps)
        self._cache = {}

    def _build_enc(self, X):
        seq = list(X)
        if len(seq) and not isinstance(seq[0], str):
            codes, lengths = _lev_ops.encode_sequences(seq)
        else:
            codes, lengths = _lev_ops.encode_strings(seq)
        myers = None
        if self.use_myers:
            from annchor_tpu.ops.levenshtein_myers import MyersEncoding

            myers = MyersEncoding.from_codes(codes, lengths)
        if myers is None:
            import jax.numpy as jnp

            codes = jnp.asarray(codes)  # upload once, reuse per call
        return (codes, lengths, myers)

    def _encode(self, X):
        # keyed by identity, but the cache entry holds a strong ref to
        # X so its id() cannot be recycled while the entry is live
        # (id()-aliasing hazard: CPython reuses addresses readily)
        key = id(X)
        hit = self._cache.get(key)
        enc = hit[1] if hit is not None and hit[0] is X else None
        if enc is None:
            enc = self._build_enc(X)
            self._cache = {key: (X, enc)}  # hold one dataset at a time
        return enc

    def _encode_transient(self, X):
        """Encode a throwaway list (e.g. the X+Q concatenation of a
        query-row oracle) WITHOUT entering the single-slot dataset
        cache — caching it would evict the fitted dataset and force a
        full re-encode + device re-upload on the next metric call."""
        return self._build_enc(X)

    def _tier(self, myers) -> dict:
        """Pair-tier arguments for the Myers kernels."""
        from annchor_tpu.ops import levenshtein_triton as lt
        from annchor_tpu.ops._backend import default_platform

        kernel = self.pair_kernel
        if kernel is None:
            gpu = default_platform() == "gpu"
            serves = lt.serves(myers.planes.shape[0], myers.W)
            kernel = "triton" if gpu and serves else "xla"
        return dict(kernel=kernel, interpret=self.interpret)

    def _pairs(self, enc, I, J):
        codes, lengths, myers = enc
        block = _adaptive_block(len(I), self.block_size)
        if myers is not None:
            from annchor_tpu import parallel
            from annchor_tpu.ops.levenshtein_myers import myers_pairs

            mesh = parallel.auto_mesh()
            if mesh is not None and block % mesh.size:
                mesh = None
            return myers_pairs(
                myers, I, J, block, mesh=mesh, **self._tier(myers)
            )
        return _lev_ops.levenshtein_pairs(codes, lengths, I, J, block)

    def batch_dev_ready(self, X):
        return self._encode(X)[2] is not None

    def batch_dev(self, X, I, J):
        """Device-id eval (Myers tiers only): I, J int32 device
        arrays -> device f32 distances, no host hop.  Large batches
        are split into bounded async dispatches (the in-program
        (B, L) text gather is ~1.6 kB per pair at 400-char strings),
        but no chunk blocks: the caller's single device_get is the
        only synchronisation point.  On a mesh the GPU kernel runs
        under shard_map, one slice of each chunk per device."""
        import jax.numpy as jnp

        from annchor_tpu import parallel
        from annchor_tpu.ops.levenshtein_myers import myers_pairs_dev

        myers = self._encode(X)[2]
        if myers is None:
            return None
        tier = self._tier(myers)
        mesh = parallel.auto_mesh() if tier["kernel"] != "xla" else None
        B = I.shape[0]
        chunk = self.dev_chunk
        outs = []
        for s in range(0, max(B, 1), chunk):
            Ic, Jc = I[s : s + chunk], J[s : s + chunk]
            bsz = Ic.shape[0]
            pad = (-bsz) % mesh.size if mesh is not None else 0
            if pad:
                Ic = jnp.concatenate([Ic, jnp.zeros(pad, Ic.dtype)])
                Jc = jnp.concatenate([Jc, jnp.zeros(pad, Jc.dtype)])
            d = myers_pairs_dev(myers, Ic, Jc, mesh=mesh, **tier)
            outs.append(d[:bsz] if pad else d)
        d = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
        return d.astype(jnp.float32)

    def fused_maxmin(self, X, na, first_ix, verbose=False):
        """Fused greedy max-min anchors via the one-vs-all Myers
        column kernel (scalar text chars -> no gathers)."""
        _, _, myers = self._encode(X)
        if myers is None:
            return None
        from annchor_tpu.ops.levenshtein_myers import myers_maxmin

        return myers_maxmin(myers, int(na), int(first_ix))

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        if Z is X:
            enc = self._encode(X)
            return self._pairs(enc, IJ[:, 0], IJ[:, 1]).astype(np.float64)
        # query path: concatenate X and Z into one encoding space
        seq = list(X) + list(Z)
        if len(seq) and not isinstance(seq[0], str):
            codes, lengths = _lev_ops.encode_sequences(seq)
        else:
            codes, lengths = _lev_ops.encode_strings(seq)
        myers = None
        if self.use_myers:
            from annchor_tpu.ops.levenshtein_myers import MyersEncoding

            myers = MyersEncoding.from_codes(codes, lengths)
        enc = (codes, lengths, myers)
        return self._pairs(enc, IJ[:, 0], IJ[:, 1] + len(X)).astype(
            np.float64
        )


class _EMDEngine:
    """Exact 1-Wasserstein via the native C++ solver (host).

    Network-simplex-style pivoting is inherently sequential, so exact
    EMD stays host-side (as in the reference, where pynndescent's
    numba kantorovich runs on CPU, utils.py:82-86).  The device-friendly
    approximation is the 'wasserstein_sinkhorn' metric.
    """

    def __init__(self, cost_matrix):
        self.cost_matrix = np.ascontiguousarray(cost_matrix, np.float64)

    def __call__(self, X, Z, IJ):
        from annchor_tpu import native

        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        X = np.ascontiguousarray(X, dtype=np.float64)
        Zc = X if Z is X else np.ascontiguousarray(Z, dtype=np.float64)
        return native.emd_batch(X, Zc, self.cost_matrix, IJ[:, 0], IJ[:, 1])


def _make_emd_scalar(cost_matrix):
    M = np.ascontiguousarray(cost_matrix, np.float64)

    def wasserstein(x, y):
        from annchor_tpu import native

        return native.emd_single(
            np.asarray(x, np.float64), np.asarray(y, np.float64), M
        )

    return wasserstein


def _make_sinkhorn(cost_matrix, **kw):
    from annchor_tpu.ops.wasserstein import SinkhornEngine

    eng = SinkhornEngine(cost_matrix, **kw)

    def scalar(x, y):
        return float(
            eng(
                np.asarray(x)[None, :],
                np.asarray(y)[None, :],
                np.array([[0, 0]]),
            )[0]
        )

    return scalar, eng


def get_function_from_input(func, func_kwargs=None):
    """Resolve a metric spec to a Metric (reference utils.py:62-107).

    Accepts: a Metric; a string in {euclidean, sqeuclidean, cosine,
    levenshtein, wasserstein, wasserstein_sinkhorn}; or any callable
    f(x, y) (optionally with kwargs bound).
    """
    if isinstance(func, Metric):
        return func

    if isinstance(func, str):
        kw = dict(func_kwargs or {})
        if func in ("euclidean", "sqeuclidean", "cosine"):
            scalar = {
                "euclidean": _euclidean_scalar,
                "sqeuclidean": lambda x, y: float(
                    np.sum((np.asarray(x) - np.asarray(y)) ** 2)
                ),
                "cosine": _cosine_scalar,
            }[func]
            return Metric(scalar, _DenseBatchEngine(func), name=func)
        if func == "levenshtein":
            return Metric(
                lambda x, y: float(_lev_ops.levenshtein_scalar(x, y)),
                _LevenshteinEngine(**kw),
                name="levenshtein",
            )
        if func == "wasserstein":
            assert func_kwargs and "cost_matrix" in func_kwargs, (
                "Error: wasserstein metric requires cost_matrix kwarg"
            )
            M = func_kwargs["cost_matrix"]
            scout = None
            if kw.pop("scout", None) == "sinkhorn":
                # scout/certify hybrid: entropic OT on the device drives
                # the search; the exact host solver certifies the
                # reported graph (see Annchor.get_ann / SURVEY.md §7)
                from annchor_tpu.ops.wasserstein import SinkhornExpEngine

                kw.pop("cost_matrix", None)
                scout = SinkhornExpEngine(M, **kw)
            return Metric(
                _make_emd_scalar(M),
                _EMDEngine(M),
                name="wasserstein",
                scout=scout,
            )
        if func == "wasserstein_sinkhorn":
            assert func_kwargs and "cost_matrix" in func_kwargs, (
                "Error: wasserstein_sinkhorn metric requires cost_matrix"
            )
            kw.pop("cost_matrix")
            scalar, eng = _make_sinkhorn(func_kwargs["cost_matrix"], **kw)
            # entropic regularisation can violate the triangle inequality
            return Metric(
                scalar, eng, name="wasserstein_sinkhorn", is_metric=False
            )
        raise AssertionError(
            "Error: The string must be one of "
            "{euclidean, sqeuclidean, cosine, levenshtein, wasserstein, "
            "wasserstein_sinkhorn}"
        )

    # arbitrary callable, with optional kwargs binding
    if func_kwargs is None:
        return Metric(func)

    def bound(x, y):
        return func(x, y, **func_kwargs)

    return Metric(bound)


# ---------------------------------------------------------------------------
# pairwise evaluation dispatch


_EXECUTORS = {}


def _shutdown_executors():
    """atexit hook: process pools otherwise leak worker handles across
    fits and can hold the interpreter open at shutdown."""
    for pool in _EXECUTORS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _EXECUTORS.clear()


atexit.register(_shutdown_executors)


def _cpu_only_worker():
    """Process-pool initializer: pin the worker's JAX to the CPU.  The
    worker has imported jax (unpickling this function imports the
    package) but has not started a backend yet, so the config update
    still takes effect."""
    import os

    import jax

    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


def _executor(backend: str):
    """Shared worker pool per backend (the reference keeps joblib's
    loky pool alive across calls for the same reason,
    reference utils.py:152-177)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os

    if backend not in _EXECUTORS:
        n = os.cpu_count() or 1
        if backend in ("loky", "multiprocessing"):
            # spawn: never fork a process holding accelerator state;
            # the initializer keeps every worker's JAX on the CPU, so
            # no worker can reserve the accelerator's memory
            _EXECUTORS[backend] = cf.ProcessPoolExecutor(
                max_workers=n, mp_context=mp.get_context("spawn"),
                initializer=_cpu_only_worker,
            )
        else:
            _EXECUTORS[backend] = cf.ThreadPoolExecutor(max_workers=n)
    return _EXECUTORS[backend]


def _chunk_eval(args):
    f, xs, zs = args
    return [f(x, z) for x, z in zip(xs, zs)]


def _fanout_scalar(f, X, Z, IJ, backend, verbose=False):
    """Arbitrary-Python-metric fallback: chunked fan-out over a worker
    pool (reference utils.py:152-177 fans the same workloads over
    joblib processes).  Threads by default — metric closures are rarely
    picklable and NumPy/SciPy metrics release the GIL; process pools on
    request via backend='loky'/'multiprocessing'.  verbose reports
    chunk progress (the reference wraps these loops in tqdm,
    reference utils.py:136,159)."""
    import os

    from annchor_tpu.progress import progress

    m = IJ.shape[0]
    ncpu = os.cpu_count() or 1
    if m < 256 or (ncpu == 1 and backend is None):
        return np.array(
            [
                f(X[i], Z[j])
                for i, j in progress(
                    IJ, "metric calls", verbose and m >= 4096, m
                )
            ],
            dtype=np.float64,
        )
    pool = _executor(backend or "threading")
    # cap the chunk size: the hang deadline below scales with it, and
    # an uncapped m//(4*ncpu) on a single-core host would stretch a
    # dead-worker stall from a minute into hours
    nchunk = max(64, min(4096, m // (4 * ncpu)))
    jobs = []
    for s in range(0, m, nchunk):
        blk = IJ[s : s + nchunk]
        xs = [X[i] for i in blk[:, 0]]
        zs = [Z[j] for j in blk[:, 1]]
        jobs.append(pool.submit(_chunk_eval, (f, xs, zs)))
    # per-chunk deadline scales with the work: a legitimately slow user
    # metric (reference workloads run to ~10 ms/call; allow 100x that)
    # must not be abandoned into the serial fallback, which would
    # double the work — the timeout only catches hung/dead workers
    deadline = max(60.0, 1.0 * nchunk)
    try:
        out = [
            v
            for job in progress(
                jobs, "metric chunks", verbose and len(jobs) > 1
            )
            for v in job.result(timeout=deadline)
        ]
    except Exception:
        # unpicklable closure under a process backend, worker death,
        # etc: finish the work serially rather than failing the fit
        for job in jobs:
            job.cancel()
        return np.array(
            [
                f(X[i], Z[j])
                for i, j in progress(
                    IJ, "metric calls", verbose and m >= 4096, m
                )
            ],
            dtype=np.float64,
        )
    return np.array(out, dtype=np.float64)


def make_get_exact_ijs(metric: Metric, verbose: bool = False, backend=None):
    """Default in-sample pairwise evaluator for a Metric.

    Returns get_exact_ijs(f, X, IJ) -> float64 (m,), preserving the
    reference plug-in contract.  The `f` argument is accepted for
    compatibility; the batched engine (if any) takes precedence, and
    arbitrary Python metrics fan out over a worker pool (see
    _fanout_scalar; reference doc/parallelisation.rst:14-52).
    """

    def get_exact(f, X, IJ):
        IJ = np.asarray(IJ)
        if metric.batch is not None:
            return metric.batch(X, X, IJ)
        return _fanout_scalar(f, X, X, IJ, backend, verbose=verbose)

    # pickers may take fused device shortcuts only when the user has
    # not overridden the evaluator (the get_exact_ijs plug-in contract,
    # reference annchor.py:77-82, must always win)
    get_exact._annchor_default = True
    return get_exact


def make_get_exact_query_ijs(
    metric: Metric, verbose: bool = False, backend=None
):
    """Query-side evaluator: pairs (X[i], Z[j])
    (reference utils.py:180-245)."""

    def get_exact(f, X, Z, IJ):
        IJ = np.asarray(IJ)
        if metric.batch is not None:
            return metric.batch(X, Z, IJ)
        return _fanout_scalar(f, X, Z, IJ, backend, verbose=verbose)

    return get_exact


def test_parallelisation(get_exact_ijs, f, X, nx, s=20, seed=42):
    """Construction-time smoke test (reference utils.py:248-271): run a
    few real metric calls so backend problems surface immediately with
    an actionable error.  A failure raises at once; nothing retries."""
    rng = np.random.default_rng(seed)
    IJ = rng.integers(nx, size=(s, 2))
    try:
        out = get_exact_ijs(f, X, IJ)
    except Exception as err:
        raise RuntimeError(
            "Metric backend smoke test failed. If you supplied a "
            "custom get_exact_ijs, check it returns "
            "np.array([f(X[i],X[j]) for i,j in IJ]); for built-in "
            "metrics check the dataset dtype matches the metric. "
            f"Original error: {err!r}"
        ) from err
    out = np.asarray(out)
    if out.shape != (s,):
        raise RuntimeError(
            "get_exact_ijs smoke test returned shape "
            f"{out.shape}, expected ({s},)"
        )
    return out
