"""Platform contracts: pinned matmul precision, compile-cache placement,
the native build key, no CPU fallback for meshes and the smoke script,
the Myers pair-tier choice, and (on a GPU only) the compiled kernels."""

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a (closed) jaxpr, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def _scout_jaxpr():
    from annchor_tpu.ops.wasserstein import _sinkhorn_exp_chunk

    X = jnp.ones((6, 4), jnp.float32)
    K = jnp.ones((4, 4), jnp.float32)
    ids = jnp.arange(3, dtype=jnp.int32)
    return jax.make_jaxpr(
        functools.partial(_sinkhorn_exp_chunk, n_iter=2)
    )(X, X, ids, ids, K, K)


def _rms_jaxpr():
    from annchor_tpu.ops.locality import _band_score

    D = jnp.ones((8, 5), jnp.float32)
    return jax.make_jaxpr(lambda a, b: _band_score(a, b, "rms"))(D, D)


def _cosine_jaxpr():
    from annchor_tpu.metrics import _dense_column

    X = jnp.ones((8, 5), jnp.float32)
    return jax.make_jaxpr(lambda a, b: _dense_column(a, b, "cosine"))(
        X, X[0]
    )


@pytest.mark.parametrize(
    "make", [_scout_jaxpr, _rms_jaxpr, _cosine_jaxpr],
    ids=["sinkhorn_scout", "rms_band_score", "cosine_column"],
)
def test_ranking_dots_pin_highest_precision(make):
    """Dots that rank or decide run in full f32 on every backend (a GPU
    would otherwise take TF32)."""
    precs = _dot_precisions(make().jaxpr)
    assert precs, "no dot_general found"
    for p in precs:
        parts = p if isinstance(p, tuple) else (p,)
        assert all(q == jax.lax.Precision.HIGHEST for q in parts), p


def _cache_dir_in_subprocess(env_updates):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_updates)
    env["PYTHONPATH"] = ROOT
    code = ("import annchor_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, check=True, cwd=ROOT,
    )
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize(
    "env, want",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/nonexistent/xx"}, "/nonexistent/xx"),
        ({"JAX_PLATFORMS": "cpu"}, "None"),
        ({}, os.path.join(ROOT, ".cache", "jax")),
    ],
    ids=["variable_set", "cpu_only", "default_in_checkout"],
)
def test_compile_cache_placement(env, want):
    """With JAX_COMPILATION_CACHE_DIR set JAX uses it and the package
    sets nothing; unset, the cache is the fixed path in the checkout;
    CPU-only processes skip the default."""
    assert _cache_dir_in_subprocess(env) == want


def test_native_build_key_tracks_source(tmp_path):
    from annchor_tpu import native

    src = tmp_path / "annchor_native.cpp"
    shutil.copy(native._SRC, src)
    key = native.build_key(str(src))
    assert key == native.build_key(native._SRC)
    with open(src, "a") as fh:
        fh.write("\n// changed\n")
    assert native.build_key(str(src)) != key
    assert native.lib_path(str(src)) != native.lib_path()


def test_native_build_key_mismatch_rebuilds(tmp_path, monkeypatch):
    """No library under the current key (another source or host built
    the one on disk): get_lib compiles anew into the keyed path."""
    from annchor_tpu import native

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    stale = tmp_path / "annchor_native-0000000000000000.so"
    stale.write_bytes(b"not a library")
    lib = native.get_lib()
    assert os.path.exists(native.lib_path())
    assert native.lib_path().startswith(str(tmp_path))
    assert lib.emd_single is not None


def _mesh_too_few(cpu_devices):
    from annchor_tpu import parallel

    parallel.mesh_for(4, devices=cpu_devices[:2])


def _dryrun_too_few(cpu_devices):
    import __graft_entry__ as graft

    graft.dryrun_multichip(4, devices=cpu_devices[:2])


@pytest.mark.parametrize("call", [_mesh_too_few, _dryrun_too_few],
                         ids=["mesh_for", "dryrun_multichip"])
def test_too_few_devices_raise(call, cpu_devices):
    """No silent swap to other devices when there are too few."""
    with pytest.raises((ValueError, RuntimeError), match="need 4"):
        call(cpu_devices)


def test_chip_smoke_refuses_non_gpu(cpu_devices):
    import chip_smoke

    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(cpu_devices)


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory the script exits non-zero, no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line_shape(cpu_devices):
    import chip_smoke

    rec = json.loads(chip_smoke.result_line(cpu_devices[:1]))
    assert rec == {
        "ok": True,
        "device": {
            "platform": "cpu",
            "kind": cpu_devices[0].device_kind,
            "count": 1,
        },
    }


def test_pair_tier_choice():
    """XLA off the GPU unless the Triton tier is asked for; the kernel
    serves the measured widths within its register budget; a bad tier
    name is refused."""
    from annchor_tpu.metrics import _LevenshteinEngine
    from annchor_tpu.ops import levenshtein_triton as lt
    from annchor_tpu.ops.levenshtein import encode_strings
    from annchor_tpu.ops.levenshtein_myers import MyersEncoding

    codes, lengths = encode_strings(["ACGT" * 30, "ACG" * 7])
    enc = MyersEncoding.from_codes(codes, lengths)
    assert enc.W == 4  # trimmed to the longest string, not the padding
    assert _LevenshteinEngine()._tier(enc)["kernel"] == "xla"
    tier = _LevenshteinEngine(pair_kernel="triton", interpret=True)._tier(enc)
    assert tier == {"kernel": "triton", "interpret": True}
    assert lt.serves(2, 32) and not lt.serves(2, 33)
    assert not lt.serves(5, 20)  # 200 plane words per lane
    with pytest.raises(ValueError, match="pair_kernel"):
        _LevenshteinEngine(pair_kernel="pallas")


def test_triton_tier_batch_dev_pads_on_mesh(cpu_devices):
    """batch_dev with the Triton tier on a 3-device mesh: the chunk is
    padded to the mesh, run under shard_map and sliced back."""
    from jax.sharding import Mesh

    from annchor_tpu import parallel
    from annchor_tpu.metrics import _LevenshteinEngine

    rng = np.random.default_rng(3)
    X = ["".join(rng.choice(list("ACGT"), size=rng.integers(5, 70)))
         for _ in range(30)]
    I = jnp.asarray(rng.integers(0, 30, size=100).astype(np.int32))
    J = jnp.asarray(rng.integers(0, 30, size=100).astype(np.int32))
    want = np.asarray(_LevenshteinEngine().batch_dev(X, I, J))
    mesh = Mesh(np.asarray(cpu_devices[:3]), (parallel.PAIR_AXIS,))
    eng = _LevenshteinEngine(pair_kernel="triton", interpret=True)
    orig = parallel.auto_mesh
    parallel.auto_mesh = lambda: mesh
    try:
        got = np.asarray(eng.batch_dev(X, I, J))
    finally:
        parallel.auto_mesh = orig
    assert got.shape == (100,)
    np.testing.assert_array_equal(got, want)


def test_process_pool_workers_stay_on_cpu(monkeypatch):
    """Spawned metric workers pin JAX to the CPU even when the parent's
    environment does not."""
    from annchor_tpu.metrics import _executor, _shutdown_executors

    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.setenv("PYTHONPATH", ROOT)
    pool = _executor("multiprocessing")
    try:
        platforms = pool.submit(os.getenv, "JAX_PLATFORMS").result(120)
    finally:
        _shutdown_executors()
    assert platforms == "cpu"


# ---------------------------------------------------------------------
# on the card only


@pytest.mark.gpu
def test_triton_kernel_compiled_matches_xla(gpu_devices):
    from annchor_tpu.datasets import make_strings
    from annchor_tpu.ops.levenshtein import encode_strings
    from annchor_tpu.ops.levenshtein_myers import (
        MyersEncoding,
        myers_pairs_dev,
    )

    X, _ = make_strings(n=400, length=500, seed=1)
    codes, lengths = encode_strings(list(X))
    enc = MyersEncoding.from_codes(codes, lengths)
    rng = np.random.default_rng(0)
    I = jnp.asarray(rng.integers(0, 400, size=5000).astype(np.int32))
    J = jnp.asarray(rng.integers(0, 400, size=5000).astype(np.int32))
    want = np.asarray(myers_pairs_dev(enc, I, J))
    got = myers_pairs_dev(enc, I, J, kernel="triton")
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.gpu
def test_sinkhorn_scout_full_f32_on_gpu(gpu_devices):
    """The scout on the card agrees with float64 to f32 accuracy, which
    TF32 matvecs would not."""
    import chip_smoke
    from annchor_tpu.datasets import grid_cost_matrix
    from annchor_tpu.ops.wasserstein import SinkhornExpEngine

    H = chip_smoke.digit_histograms(n=200)
    M = grid_cost_matrix(8, 8)
    eng = SinkhornExpEngine(M)
    IJ = np.random.default_rng(0).integers(200, size=(512, 2))
    got = eng(H, H, IJ)
    Hn = H / H.sum(axis=1, keepdims=True)
    want = chip_smoke.sinkhorn_f64(Hn[IJ[:, 0]], Hn[IJ[:, 1]], M, eng.eps,
                                   eng.n_iter)
    np.testing.assert_allclose(got, want, rtol=chip_smoke.SINKHORN_RTOL)
