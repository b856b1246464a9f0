"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §2.2: pair batches sharded over the device mesh)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from annchor_tpu import parallel


@pytest.fixture(scope="module")
def mesh(cpu_devices):
    return parallel.mesh_for(8, devices=cpu_devices)


def test_mesh_for(cpu_devices):
    m = parallel.mesh_for(4, devices=cpu_devices)
    assert m.devices.shape == (4,)
    assert m.axis_names == (parallel.PAIR_AXIS,)


def test_pad_to_multiple():
    a = np.arange(10)
    (p,), n = parallel.pad_to_multiple([a], 8)
    assert n == 10
    assert p.shape[0] == 16
    np.testing.assert_array_equal(p[:10], a)
    (q,), n2 = parallel.pad_to_multiple([np.arange(16)], 8)
    assert q.shape[0] == 16 and n2 == 16


def test_sharded_euclidean_matches_unsharded(mesh, rng):
    """The canonical pattern: dataset replicated, pair indices sharded
    over the mesh; result equals the single-device kernel."""
    X = rng.normal(size=(50, 4)).astype(np.float32)
    I = rng.integers(0, 50, size=64).astype(np.int32)
    J = rng.integers(0, 50, size=64).astype(np.int32)

    def kern(X, I, J):
        a = jnp.take(X, I, axis=0)
        b = jnp.take(X, J, axis=0)
        return jnp.sqrt(jnp.sum((a - b) ** 2, axis=1))

    run = parallel.sharded_pair_kernel(kern, mesh, n_replicated=1)
    got = np.asarray(run(X, I, J))
    want = np.linalg.norm(X[I] - X[J], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sharded_levenshtein_matches_unsharded(mesh, rng):
    from annchor_tpu.ops.levenshtein import _lev_batch, encode_strings

    strs = [
        "".join(rng.choice(list("abcd"), size=int(rng.integers(5, 30))))
        for _ in range(24)
    ]
    codes, lengths = encode_strings(strs)
    I = rng.integers(0, 24, size=32).astype(np.int32)
    J = rng.integers(0, 24, size=32).astype(np.int32)
    la = np.minimum(lengths[I], lengths[J])
    lb = np.maximum(lengths[I], lengths[J])
    swap = lengths[I] > lengths[J]
    I2 = np.where(swap, J, I).astype(np.int32)
    J2 = np.where(swap, I, J).astype(np.int32)

    def kern(codes, I, J, la, lb):
        a = jnp.take(codes, I, axis=0)
        b = jnp.take(codes, J, axis=0)
        return _lev_batch(a, b, la, lb)

    run = parallel.sharded_pair_kernel(kern, mesh, n_replicated=1)
    got = np.asarray(run(codes, I2, J2, la, lb))
    want = np.asarray(
        _lev_batch(
            jnp.asarray(codes[I2]),
            jnp.asarray(codes[J2]),
            jnp.asarray(la),
            jnp.asarray(lb),
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_dryrun_multichip_8():
    """The driver's multi-chip validation path."""
    import sys
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_uneven_mesh():
    import sys
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as graft

    graft.dryrun_multichip(4)
    graft.dryrun_multichip(2)


def test_entry_compiles_on_cpu():
    import sys
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as graft

    fn, args = graft.entry()
    with jax.default_device(jax.devices("cpu")[0]):
        out = jax.jit(fn)(*args)
    assert all(np.isfinite(np.asarray(o)).all() for o in out)


def test_engine_sharded_equivalence(mesh, rng, monkeypatch):
    """Metric engines must give identical results when auto_mesh
    reports a multi-device mesh (engine-level shard_map wiring)."""
    from annchor_tpu import parallel as par
    from annchor_tpu.metrics import get_function_from_input

    X = rng.normal(size=(64, 5))
    IJ = rng.integers(0, 64, size=(100, 2))
    m = get_function_from_input("euclidean", None)
    plain = m.batch(X, X, IJ)
    monkeypatch.setattr(par, "auto_mesh", lambda: mesh)
    m2 = get_function_from_input("euclidean", None)
    sharded = m2.batch(X, X, IJ)
    np.testing.assert_allclose(sharded, plain, rtol=1e-6)


def test_levenshtein_engine_sharded_equivalence(mesh, rng, monkeypatch):
    from annchor_tpu import parallel as par
    from annchor_tpu.metrics import get_function_from_input

    strs = [
        "".join(rng.choice(list("abcd"), size=int(rng.integers(5, 60))))
        for _ in range(40)
    ]
    IJ = rng.integers(0, 40, size=(333, 2))
    m = get_function_from_input("levenshtein", None)
    plain = m.batch(strs, strs, IJ)
    monkeypatch.setattr(par, "auto_mesh", lambda: mesh)
    m2 = get_function_from_input("levenshtein", None)
    sharded = m2.batch(strs, strs, IJ)
    np.testing.assert_array_equal(sharded, plain)
