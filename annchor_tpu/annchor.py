"""Annchor: accelerator-native approximate k-NN graphs for slow metrics.

This is the top-level orchestrator, a ground-up JAX/XLA re-design of
the reference pipeline (reference annchor/annchor.py:21-940):

  anchors -> locality -> features -> [sample -> regress -> errors ->
  refine -> tighten]*niters -> graph

Every hot stage runs as a batched device kernel (see annchor_tpu.ops);
the orchestration itself is a staged host loop because the control flow
(early exit on NothingToSample, adaptive warnings, user-pluggable
strategy objects) is inherently dynamic — the pipeline is naturally
staged, so nothing is lost to jit boundaries.

State arrays mirror the reference semantics but live in padded/flat
tensors instead of numba Dicts:
  IJs   int32 (m, 2)  candidate pairs, IJs[:,0] < IJs[:,1]
  P_idx int32 (nx, max_deg) per-point pair ids (pad = m)
  RefineApprox float64 (m,)  current best estimate per pair
  not_computed_mask bool (m,)
"""

from __future__ import annotations

import os
import time

import numpy as np

from annchor_tpu.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu.metrics import (
    get_function_from_input,
    make_get_exact_ijs,
    make_get_exact_query_ijs,
    test_parallelisation,
)
from annchor_tpu.ops import pairs as pair_ops
from annchor_tpu.ops.bounds_update import tighten_bounds
from annchor_tpu.ops.features import bounds_and_dad
from annchor_tpu.ops.locality import candidate_pairs, candidate_pairs_device
from annchor_tpu.pickers import MaxMinAnchorPicker
from annchor_tpu.regressors import SimpleStratifiedLinearRegression
from annchor_tpu.samplers import NothingToSample, SimpleStratifiedSampler

__all__ = ["Annchor", "BruteForce", "compare_neighbor_graphs"]


class Annchor:
    """Quickly computes the approximate k-NN graph for slow metrics.

    Parameters mirror the reference API (reference annchor.py:26-90):

    X: np.array or list — the data set.
    func: callable, Metric or string — the metric. Supported strings:
        euclidean, sqeuclidean, cosine, levenshtein,
        wasserstein (exact EMD; requires cost_matrix kwarg),
        wasserstein_sinkhorn (device entropic OT; requires cost_matrix).
    func_kwargs: dict of metric kwargs.
    n_anchors, n_neighbors, n_samples, p_work: budget knobs; p_work is
        the fraction of brute-force metric calls we may spend.
    anchor_picker / sampler / regression / error_predictor: duck-typed
        strategy objects (reference annchor.py:150-161).
    locality / loc_thresh / loc_min: candidate filter knobs.
    is_metric: False disables triangle-inequality clipping
        (reference annchor.py:73-76).
    get_exact_ijs: optional user pairwise evaluator
        get_exact_ijs(f, X, IJ) -> np.array([f(X[i], X[j]) ...]).
    backend: worker pool for *arbitrary Python* metrics (built-in
        metrics use batched engines and ignore it, with a warning):
        None/"threading" -> shared thread pool,
        "loky"/"multiprocessing" -> spawned process pool (the metric
        must be picklable; unpicklable closures fall back to serial).
    refine_frac / refine_rounds: hold back refine_frac of the p_work
        allowance and spend it after the fit on graph-expansion
        refinement (refine_neighbor_graph) — same total eval budget,
        redirected at near-misses; recovers edges outside the
        candidate set.  0 reproduces the reference flow.  Split only
        when the fit is *coverage-limited* (tight pair caps /
        selective filters): with full candidate coverage the
        re-targeted in-fit evals beat post-hoc expansion (ROADMAP.md).

    Knobs left unset (None) resolve to the reference defaults at
    reference scales (nx <= 4096) and to the measured tuning law on
    the scale path — see docs/parameters.md "Scale-aware defaults".
    """

    def __init__(
        self,
        X,
        func,
        func_kwargs=None,
        n_anchors=None,
        n_neighbors=15,
        n_samples=5000,
        p_work=0.1,
        anchor_picker=None,
        sampler=None,
        regression=None,
        error_predictor=None,
        random_seed=42,
        locality=None,
        loc_thresh=None,
        loc_min=None,
        verbose=False,
        is_metric=True,
        get_exact_ijs=None,
        backend=None,
        niters=None,
        lookahead=5,
        trace_dir=None,
        refine_frac=None,
        refine_rounds=3,
        pair_cap=None,
        pair_cap_factor=None,
        max_resident_pairs=None,
    ):
        self.X = X
        self.nx = len(X)
        self.N = (self.nx * (self.nx - 1)) // 2

        # Scale-aware defaults (None = unset): at reference scales
        # (nx <= 4096) every knob resolves to the reference default,
        # so behavior is identical; on the scale path the defaults
        # follow the measured tuning law (ROADMAP.md tuning laws: more anchors =
        # fewer candidate pairs at the same filter coverage —
        # na ~ 0.3*sqrt(nx); a selective loc_thresh=3 filter; four
        # budget iterations; 5% of p_work held back for post-fit
        # graph expansion, which beats spending it in-fit when the
        # pair budget caps coverage).  The last measured default-ctor
        # 100k fit before this law cost 6x the tuned wall at 11%
        # missing edges (VERDICT r4) — ctor kwargs are the config
        # system, so the tuned frontier is what the defaults embody.
        scale = self.nx > 4096
        if n_anchors is None:
            n_anchors = (
                max(48, int(round(0.3 * self.nx ** 0.5 / 16.0)) * 16)
                if scale
                else 20
            )
        if locality is None:
            locality = 5
        if loc_thresh is None:
            loc_thresh = 3 if scale else 1
        if niters is None:
            niters = 4 if scale else 2
        if refine_frac is None:
            refine_frac = 0.05 if scale else 0.0

        self.metric = get_function_from_input(func, func_kwargs)
        self.f = self.metric.scalar
        self.evals = 0

        self.n_anchors = n_anchors
        # deduplicated anchor-pair count used in the work budget
        # (reference annchor.py:126)
        self.na = int(
            np.sum([self.nx - j for j in range(1, self.n_anchors + 1)])
        )

        self.n_neighbors = n_neighbors
        self.p_work = p_work
        self.n_samples = n_samples

        if self.p_work > 1:
            print("Warning: p_work should not exceed 1.  Setting it to 1.")
            self.p_work = 1.0
        min_p_work = (2 * (self.na + self.n_samples) + 1) / self.N
        min_p_work = 1 if min_p_work > 1 else min_p_work
        if self.p_work < min_p_work:
            print("Warning: Too many anchors/samples for specified p_work.")
            print("Increasing p_work to %5.3f." % min_p_work)
            self.p_work = min_p_work
        if self.p_work > 0.75:
            print("Warning: High Value of p_work.")
            print(
                "Think about decreasing n_anchors or n_samples,"
                + " or using BruteForce."
            )

        self.anchor_picker = anchor_picker or MaxMinAnchorPicker()
        self.sampler = sampler or SimpleStratifiedSampler()
        self.regression = regression or SimpleStratifiedLinearRegression()
        self.error_predictor = (
            error_predictor or SimpleStratifiedErrorRegression()
        )

        self.random_seed = random_seed
        self.verbose = verbose
        self.locality = locality
        self.loc_thresh = loc_thresh
        self.loc_min = 10 * self.n_neighbors if loc_min is None else loc_min
        self.loc_min = int(np.clip(self.loc_min, 0, self.nx - 1))
        self.is_metric = bool(is_metric) and self.metric.is_metric
        self.niters = niters
        self.lookahead = lookahead
        # budget split: reserve refine_frac of the p_work allowance
        # for post-fit graph-expansion refinement (same total evals,
        # redirected at the near-misses the in-fit ranking leaves)
        self.refine_frac = float(np.clip(refine_frac, 0.0, 0.9))
        self.refine_rounds = int(refine_rounds)
        # scale-path pair-budget knobs (ROADMAP.md tuning laws): explicit per-point
        # candidate cap, derived-cap factor (cap = max(4*nn,
        # factor * p_work * nx * mesh)), and the resident-pair bound
        # past which non-metric fits auto-switch to the budgeted
        # build.  Constructor kwargs are the config system (reference
        # annchor.py:92-115); the ANNCHOR_TPU_* env vars of the same
        # names remain available as overrides for sweeps.
        self.pair_cap = None if pair_cap is None else int(pair_cap)
        self.pair_cap_factor = (
            None if pair_cap_factor is None else float(pair_cap_factor)
        )
        self.max_resident_pairs = (
            None if max_resident_pairs is None else int(max_resident_pairs)
        )
        self.trace_dir = trace_dir

        self._features = None
        self._RefineApprox = None
        self._ncm = None
        self._P_idx = None
        self._IJs = None
        self._ij_dev = None  # device-built pair list (scale path)
        self._dev = None  # device-resident state (ops.device_pipeline)
        self._pair_build = None  # which candidate-pair builder ran
        self._dev_eval = None  # device-id metric eval (fused pipeline)
        self._S_raw = None  # lazy locality by-products (S/sid/loc_eff)
        self._sid_raw = None
        self._loc_eff_raw = None
        self.neighbor_graph = None

        self.backend = backend
        if backend is not None and self.metric.batch is not None:
            print(
                "Warning: backend=%r is ignored for metric %r — it has "
                "a batched engine (backend selects the worker pool for "
                "arbitrary Python metrics only)." % (backend, self.metric.name)
            )
        if get_exact_ijs is None:
            self.get_exact_ijs = make_get_exact_ijs(
                self.metric, verbose=self.verbose, backend=backend
            )
        else:
            self.get_exact_ijs = get_exact_ijs

        # scout/certify hybrid: when the metric ships a cheap
        # approximate engine (e.g. wasserstein with scout="sinkhorn"),
        # exploration runs on it and only the final graph edges are
        # evaluated with the exact metric (a few percent of the
        # p_work budget).  A user-supplied evaluator always wins.
        self.scout_evals = 0
        self.certify_pad = 8
        # scout-screened graph expansion inside _certify (see there)
        self.certify_expand_rounds = 2
        self.certify_expand_cap = None  # None -> 32 * nx
        self._scouting = False
        scout = getattr(self.metric, "scout", None)
        if scout is not None and getattr(
            self.get_exact_ijs, "_annchor_default", False
        ):
            self._exact_eval = self.get_exact_ijs

            def scout_eval(f, X, IJ):
                return scout(X, X, np.asarray(IJ))

            scout_eval._annchor_default = True
            self.get_exact_ijs = scout_eval
            self._scouting = True
            # entropic values carry an O(eps) bias that can violate
            # the triangle inequality: take the non-metric path
            # (reference annchor.py:73-76)
            self.is_metric = False

        test_parallelisation(self.get_exact_ijs, self.f, self.X, self.nx, s=20)
        self.get_exact_query_ijs = None

    # -- device-resident state & lazy host mirrors -------------------------
    #
    # With default strategy objects the fit keeps the per-pair state on
    # device (ops.device_pipeline) and only kilobytes cross the host
    # link per iteration; the full arrays are materialised on first
    # host access (plug-ins, persistence, the instance-selection
    # extras).  Custom strategy objects get the host pipeline, whose
    # semantics these properties mirror exactly.

    def _sync_from_device(self):
        if self._dev is not None:
            (
                self._features,
                self._RefineApprox,
                self._ncm,
            ) = self._dev.materialise()
            self._dev = None

    @property
    def features(self):
        self._sync_from_device()
        return self._features

    @features.setter
    def features(self, value):
        self._sync_from_device()
        self._features = value

    @property
    def RefineApprox(self):
        self._sync_from_device()
        return self._RefineApprox

    @RefineApprox.setter
    def RefineApprox(self, value):
        self._sync_from_device()
        self._RefineApprox = value

    @property
    def not_computed_mask(self):
        if self._dev is not None:
            return self._dev.ncm_to_host()
        return self._ncm

    @not_computed_mask.setter
    def not_computed_mask(self, value):
        self._sync_from_device()
        self._ncm = value

    def _device_pipeline_ok(self):
        """The device fast path assumes the default strategy stack
        (their numeric contracts are baked into the jitted programs);
        any custom strategy object falls back to the host pipeline,
        preserving the full plug-in surface."""
        import os

        from annchor_tpu.samplers import SimpleStratifiedSampler

        if os.environ.get("ANNCHOR_TPU_DISABLE_DEVICE_PIPELINE"):
            return False
        dad = "double anchor distance"
        return (
            type(self.sampler) is SimpleStratifiedSampler
            and self.sampler.partition_feature_name == dad
            and type(self.regression) is SimpleStratifiedLinearRegression
            and self.regression.partition_feature_name == dad
            and list(self.regression.reg_feature_names)
            == ["lower bound", "upper bound", dad]
            and type(self.error_predictor)
            is SimpleStratifiedErrorRegression
            and self.error_predictor.partition_feature_name == dad
        )

    # -- helpers ----------------------------------------------------------

    def _get_exact_query_ijs_for(self, f):
        if self.get_exact_query_ijs is None:
            self.get_exact_query_ijs = make_get_exact_query_ijs(
                self.metric,
                verbose=self.verbose,
                backend=getattr(self, "backend", None),
            )
        return self.get_exact_query_ijs

    def _eval_pairs(self, IJ):
        """Evaluate distances for pairs through the active evaluator
        (the scout engine during a hybrid fit), counting evals."""
        d = np.asarray(
            self.get_exact_ijs(self.f, self.X, np.asarray(IJ)),
            dtype=np.float64,
        )
        if self._scouting:
            self.scout_evals += d.shape[0]
        else:
            self.evals += d.shape[0]
        return d

    # -- pipeline stages ---------------------------------------------------

    def get_anchors(self):
        """Anchors + (nx, n_anchors) distance columns
        (reference annchor.py:191-206)."""
        self.A, self.D, evals = self.anchor_picker.get_anchors(self)
        if self._scouting:
            self.scout_evals += evals
        else:
            self.evals += evals

    @property
    def IJs(self):
        """Candidate pair array (m, 2).  On large device-pipeline fits
        the pair list is built and kept on device
        (ops.locality.candidate_pairs_device); the host copy is only
        assembled if someone actually asks for it."""
        if self._IJs is None and self._ij_dev is not None:
            ij_i, ij_j, m = self._ij_dev
            # sharded states pad the pair arrays to m_pad with
            # sentinels; the host view is the first m real rows
            self._IJs = np.stack(
                [np.asarray(ij_i)[:m], np.asarray(ij_j)[:m]], axis=1
            )
        return self._IJs

    @IJs.setter
    def IJs(self, value):
        self._IJs = value
        self._ij_dev = None

    @property
    def P_idx(self):
        """Padded point-incidence matrix (lazy: large device-pipeline
        fits never need the host copy, and at 10^8 pairs it is
        hundreds of MB + a comparison sort)."""
        if self._P_idx is None:
            self._P_idx, _ = pair_ops.build_point_index(self.IJs, self.nx)
        return self._P_idx

    @P_idx.setter
    def P_idx(self, value):
        self._P_idx = value

    # locality by-products stay device-resident through the fit (the
    # fit never reads them; query/enemies/persistence materialise
    # lazily — the S download alone is nx^2 bytes of link traffic)

    @property
    def S(self):
        if self._S_raw is not None and not isinstance(
            self._S_raw, np.ndarray
        ):
            self._S_raw = np.asarray(self._S_raw)
        return self._S_raw

    @S.setter
    def S(self, value):
        self._S_raw = value

    @property
    def sid(self):
        if self._sid_raw is not None and not isinstance(
            self._sid_raw, np.ndarray
        ):
            self._sid_raw = np.asarray(self._sid_raw)
        return self._sid_raw

    @sid.setter
    def sid(self, value):
        self._sid_raw = value

    @property
    def loc_eff(self):
        if self._loc_eff_raw is not None and not isinstance(
            self._loc_eff_raw, np.ndarray
        ):
            self._loc_eff_raw = np.asarray(self._loc_eff_raw)
        return self._loc_eff_raw

    @loc_eff.setter
    def loc_eff(self, value):
        self._loc_eff_raw = value

    def get_locality(self):
        """Candidate pairs from shared near-anchor sets
        (reference annchor.py:208-256). Builds IJs and the padded
        point-incidence index (lazily for large device-pipeline fits)."""
        force_sparse = bool(
            os.environ.get("ANNCHOR_TPU_FORCE_SPARSE")
        )  # test hook: exercise the scale path at small nx
        if (
            self.nx > 4096 or force_sparse
        ) and self._device_pipeline_ok():
            # scale path: pair list built and kept on device — nothing
            # O(m) crosses the link or touches the host here.  With a
            # pair budget (ANNCHOR_TPU_PAIR_CAP per-point candidates)
            # the two-pass streaming build bounds resident pairs by the
            # budgeted set, lifting the single-chip HBM wall that caps
            # coverage at nx ~ 10^5 on a 16 GB card.
            # env wins even at 0 (docs/parameters.md: the variable is
            # the sweep override) — `or` would let a falsy 0 fall
            # through to the ctor kwarg and sweep the wrong config
            env_cap = os.environ.get("ANNCHOR_TPU_PAIR_CAP")
            pair_cap = (
                int(env_cap) if env_cap is not None
                else (self.pair_cap or 0)
            )
            if pair_cap > 0:
                from annchor_tpu.ops.locality import (
                    candidate_pairs_device_budgeted,
                )

                (
                    ij_i, ij_j, m,
                    self.sid, self.S, self.loc_eff, self.P_cnt,
                ) = candidate_pairs_device_budgeted(
                    self.D, self.locality, self.loc_thresh,
                    self.loc_min, pair_cap, verbose=self.verbose,
                )
                self._pair_build = "device-budgeted"
            elif self.is_metric and not os.environ.get(
                "ANNCHOR_TPU_NO_PAIR_BUDGET"
            ):
                # metric fits default to the budgeted build with the
                # cap matched to the refine budget: keeping each
                # point's 0.7 * p_work * nx smallest-lower-bound
                # candidates concentrates every per-pair pass on pairs
                # the budget could ever refine.  Measured (ROADMAP.md
                # tuning laws): identical eval counts, equal-or-better
                # recall, and faster fits than the uncapped build —
                # the lb-ranked discard loses almost no truth in a
                # metric space.  ANNCHOR_TPU_NO_PAIR_BUDGET=1 restores
                # the admit-everything build.
                from annchor_tpu.ops.locality import (
                    candidate_pairs_device_budgeted,
                )

                auto_cap = max(
                    4 * self.n_neighbors,
                    int(
                        round(
                            self._pair_cap_factor()
                            * self._p_work_fit
                            * self.nx
                            * self._mesh_scale()
                        )
                    ),
                )
                (
                    ij_i, ij_j, m,
                    self.sid, self.S, self.loc_eff, self.P_cnt,
                ) = candidate_pairs_device_budgeted(
                    self.D, self.locality, self.loc_thresh,
                    self.loc_min, auto_cap, verbose=self.verbose,
                )
                self._pair_build = "device-budgeted"
            else:
                # non-metric fits (triangle lb invalid as a ranking
                # signal): admit everything the filter keeps; the
                # counting pass still falls back to the budgeted
                # build when the admitted set would OOM the fit's
                # O(m) device state
                env_res = os.environ.get("ANNCHOR_TPU_MAX_RESIDENT_PAIRS")
                max_res = int(
                    env_res
                    if env_res is not None
                    else (
                        10**8
                        if self.max_resident_pairs is None
                        else self.max_resident_pairs
                    )
                )
                auto_cap = max(
                    4 * self.n_neighbors,
                    int(
                        round(
                            self._pair_cap_factor()
                            * self._p_work_fit
                            * self.nx
                            * self._mesh_scale()
                        )
                    ),
                )
                (
                    ij_i, ij_j, m,
                    self.sid, self.S, self.loc_eff, self.P_cnt,
                ) = candidate_pairs_device(
                    self.D, self.locality, self.loc_thresh,
                    self.loc_min, verbose=self.verbose,
                    max_resident=max_res, budget_cap=auto_cap,
                )
                self._pair_build = "device"
            self._IJs = None
            self._ij_dev = (ij_i, ij_j, m)
            self._P_idx = None  # device pipeline builds its own
        else:
            self.IJs, self.sid, self.S, self.loc_eff = candidate_pairs(
                self.D, self.locality, self.loc_thresh, self.loc_min
            )
            self._pair_build = "host"
            if self._device_pipeline_ok():
                # the device pipeline builds its own incidence matrix;
                # the host copy stays lazy (P_idx property) — skipping
                # the host comparison sort saves seconds per fit on the
                # single-core host
                self._P_idx = None
                self.P_cnt = (
                    np.bincount(self.IJs[:, 0], minlength=self.nx)
                    + np.bincount(self.IJs[:, 1], minlength=self.nx)
                ).astype(np.int32)
            else:
                self.P_idx, self.P_cnt = pair_ops.build_point_index(
                    self.IJs, self.nx
                )
        if (self.P_cnt < self.n_neighbors).any():
            raise Exception(
                "Error: Not enough candidates in pool for all indices.\n"
                + "Try again with higher locality."
            )

    def _pair_cap_factor(self) -> float:
        env = os.environ.get("ANNCHOR_TPU_PAIR_CAP_FACTOR")
        if env is not None:
            return float(env)
        return 0.7 if self.pair_cap_factor is None else self.pair_cap_factor

    def _mesh_scale(self) -> int:
        """Device count the fit state will shard over (1 single-chip).

        The *derived* pair cap scales with the mesh so multi-chip buys
        candidate coverage, not just residency: each chip still holds
        ~cap_1chip * nx / s pairs, but the tracked set is s times
        wider.  An explicit ANNCHOR_TPU_PAIR_CAP never scales — the
        sharded fit is bit-identical to the single-chip fit whenever
        the tracked pair set matches (tests/test_sharded_fit.py pins
        this at matched caps)."""
        from annchor_tpu import parallel

        mesh = parallel.auto_mesh()
        return 1 if mesh is None else int(mesh.size)

    def get_features_IJ(self, IJs, P_idx=None):
        """Per-pair features (reference annchor.py:258-303)."""
        lb, ub, dad = bounds_and_dad(self.D, IJs[:, 0], IJs[:, 1])
        if len(self.A):
            anchor_set = np.zeros(self.nx, dtype=bool)
            anchor_set[np.asarray(self.A, dtype=int)] = True
            anchors = (
                anchor_set[IJs[:, 0]] | anchor_set[IJs[:, 1]]
            ).astype(np.float64)
        else:
            anchors = np.zeros(IJs.shape[0])
        features = np.stack([lb, ub, dad, anchors], axis=1)
        feature_names = [
            "lower bound",
            "upper bound",
            "double anchor distance",
            "is anchor",
        ]
        not_computed_mask = features[:, 3] < 1
        return feature_names, features, not_computed_mask

    def get_features(self):
        if self._device_pipeline_ok():
            from annchor_tpu.ops.device_pipeline import DeviceFitState

            self.feature_names = [
                "lower bound",
                "upper bound",
                "double anchor distance",
                "is anchor",
            ]
            self._dev = DeviceFitState(self)
            self._dev_eval = self._make_device_eval()
            return
        (
            self.feature_names,
            self.features,
            self.not_computed_mask,
        ) = self.get_features_IJ(self.IJs)

    def _make_device_eval(self):
        """Device-id metric eval closure for the fused fit pipeline,
        or None.  Only the default evaluator qualifies (a user
        get_exact_ijs keeps the host hop, whose exact call sequence is
        part of the plug-in contract).  Works on the sharded path too:
        selection coordinates come back replicated, the metric kernel
        evaluates them replicated, and the scatter lands on the
        owning shard — values are bit-identical to the unfused flow
        (same kernel, same f32 math), which the sharded-vs-single
        equality tests continue to pin."""
        if os.environ.get("ANNCHOR_TPU_DISABLE_FUSED_EVAL"):
            return None
        if self._dev is None:
            return None
        if not getattr(self.get_exact_ijs, "_annchor_default", False):
            return None
        # during a hybrid fit the scout engine IS the active evaluator
        eng = (
            getattr(self.metric, "scout", None)
            if self._scouting
            else getattr(self.metric, "batch", None)
        )
        if eng is None or not hasattr(eng, "batch_dev"):
            return None
        try:
            if not eng.batch_dev_ready(self.X):
                return None
        except Exception:
            return None
        X = self.X

        def run(I, J):
            return eng.batch_dev(X, I, J)

        return run

    def get_sample(self):
        """Stratified sample of pairs + their exact distances
        (reference annchor.py:313-343)."""
        if self._dev is not None:
            # default-sampler semantics, drawn on device: quantile
            # edges + stratified without-replacement pick + feature
            # rows + pair coords (+ the exact sample distances when the
            # metric has a device-id engine), all in one round trip
            (
                self.sample_ixs,
                self.sample_bins,
                self.sample_features,
                self.sample_ijs,
                sample_y,
            ) = self._dev.draw_sample(
                self.sampler,
                self.n_samples,
                self.random_seed,
                batch_dev=self._dev_eval,
            )
            self.n_samples = self.sample_ixs.shape[0]
            if sample_y is not None:
                self.sample_y = sample_y
                if self._scouting:
                    self.scout_evals += sample_y.shape[0]
                else:
                    self.evals += sample_y.shape[0]
            else:
                self.sample_y = self._eval_pairs(self.sample_ijs)
            # ncm flips on device inside regress_update
            return
        (
            self.sample_ixs,
            self.n_samples,
            self.sample_bins,
        ) = self.sampler.sample(
            self.features,
            self.feature_names,
            self.n_samples,
            self.not_computed_mask,
            self.random_seed,
        )
        self.sample_features = self.features[self.sample_ixs]
        self.sample_ijs = self.IJs[self.sample_ixs]
        self.sample_y = self._eval_pairs(self.sample_ijs)
        self.not_computed_mask[self.sample_ixs] = False

    def fit_predict_regression(self):
        """Fit distance regression, predict all pairs, clip to bounds
        (reference annchor.py:345-380)."""
        self.regression.fit(
            self.sample_features,
            self.feature_names,
            self.sample_y,
            sample_bins=self.sample_bins,
        )
        if self._dev is not None:
            self.sample_predict = self._dev.regress_update(
                self.regression,
                self.sample_ixs,
                self.sample_y,
                self.sample_features,
            )
            return
        self.pred = self.regression.predict(self.features, self.feature_names)
        self.sample_predict = self.pred[self.sample_ixs]

        ilb = self.feature_names.index("lower bound")
        iub = self.feature_names.index("upper bound")
        self.pred = np.clip(
            self.pred, self.features[:, ilb], self.features[:, iub]
        )

        # without the triangle inequality the anchor-pair rows must be
        # overwritten with their exact column values
        # (reference annchor.py:365-372)
        if not self.is_metric and len(self.A):
            m = self.IJs.shape[0]
            for col, a in enumerate(np.asarray(self.A, dtype=int)):
                ids = self.P_idx[a][self.P_idx[a] < m]
                others = self.IJs[ids].sum(axis=1) - a
                self.pred[ids] = self.D[others, col]

        if self.RefineApprox is None:
            self.RefineApprox = self.pred.copy()
        else:
            self.RefineApprox[self.not_computed_mask] = self.pred[
                self.not_computed_mask
            ]
        self.RefineApprox[self.sample_ixs] = self.sample_y

    def fit_predict_errors(self):
        """Fit the empirical residual CDFs (reference annchor.py:382-393)."""
        self.error_predictor.fit(
            self.sample_features,
            self.feature_names,
            self.sample_y - self.sample_predict,
            sample_bins=self.sample_bins,
        )
        if self._dev is not None:
            return  # per-pair bin labels are recomputed on device
        self.errors = self.error_predictor.predict(
            self.features, self.feature_names
        )

    @property
    def _p_work_fit(self):
        """The in-fit share of the eval allowance: refine_frac of
        p_work is held back for post-fit graph-expansion refinement
        (same total budget, redirected).  Scout/certify hybrids keep
        the full allowance — their exploration runs on the scout and
        certify already includes graph expansion."""
        if self._scouting:
            return self.p_work
        return self.p_work * (1.0 - self.refine_frac)

    def select_refine_candidate_pairs(self, w=0.5, it=0):
        """Spend the refine budget on the pairs most likely to be true
        k-NN edges (reference annchor.py:395-473)."""
        nn = self.n_neighbors
        if self._dev is not None:
            n_refine = int(
                (self._p_work_fit * self.N - self.na - self.n_samples) * w
            ) + 1
            self.nextback = np.zeros(0, dtype=np.int64)
            if self._dev_eval is not None:
                n_done = self._dev.select_refine_fused(
                    self.error_predictor,
                    max(n_refine, 0),
                    nn,
                    it == 0,
                    3 * nn // 2,
                    self._dev_eval,
                )
                if self._scouting:
                    self.scout_evals += n_done
                else:
                    self.evals += n_done
                return
            candidates, cand_IJ = self._dev.select(
                self.error_predictor,
                max(n_refine, 0),
                nn,
                it == 0,
                3 * nn // 2,
            )
            if candidates.shape[0]:
                exact = self._eval_pairs(cand_IJ)
                self._dev.apply_exact(candidates, exact)
            return
        thresh = np.asarray(
            pair_ops.kth_smallest_per_point(
                self.RefineApprox, self.P_idx, nn
            ),
            dtype=np.float64,
        )
        self.thresh = thresh

        if it == 0:
            self.RefineApprox = pair_ops.guarantee_nmin(
                self.RefineApprox,
                self.not_computed_mask,
                self.P_idx,
                self.P_cnt,
                3 * nn // 2,
            )

        ncm = self.not_computed_mask
        RA_ncm = self.RefineApprox[ncm]
        p = (
            np.maximum(
                thresh[self.IJs[ncm, 0]], thresh[self.IJs[ncm, 1]]
            )
            - RA_ncm
        )
        prob = pair_ops.empirical_cdf_probs(
            p, self.errors[ncm], self.error_predictor.errs
        )

        n_refine = int(
            (self._p_work_fit * self.N - self.na - self.n_samples) * w
        ) + 1
        n_refine = max(n_refine, 0)

        if n_refine >= prob.shape[0]:
            candidates = np.arange(prob.shape[0])
            nxt = np.arange(prob.shape[0])
        else:
            if n_refine * self.lookahead >= prob.shape[0]:
                large_part = np.arange(prob.shape[0])
            else:
                large_part = np.argpartition(
                    -prob, n_refine * self.lookahead
                )[: n_refine * self.lookahead]
            argpart = np.argpartition(-prob[large_part], n_refine)
            candidates = large_part[argpart[:n_refine]]
            nxt = large_part[argpart[n_refine:]]

        ncm_ids = np.arange(ncm.shape[0])[ncm]
        self.nextback = ncm_ids[nxt]
        mapback = ncm_ids[candidates]

        exact = self._eval_pairs(self.IJs[mapback])
        self.RefineApprox[mapback] = exact
        self.not_computed_mask[mapback] = False

    def _contender_ids(self):
        """Uncomputed pairs that could still enter a top-k list: their
        lower bound is below the larger endpoint threshold.  Anything
        else can never displace a current neighbour, so spending
        tightening work on it is wasted."""
        ncm_ids = np.flatnonzero(self.not_computed_mask)
        lb = self.features[ncm_ids, 0]
        cap = np.maximum(
            self.thresh[self.IJs[ncm_ids, 0]],
            self.thresh[self.IJs[ncm_ids, 1]],
        )
        return ncm_ids[lb < cap]

    def update_anchor_points(self, timeout=10, chunk_size=200000):
        """Bound tightening between iterations: every computed distance
        acts as a pseudo-anchor for still-pending pairs (reference
        annchor.py:475-512 / utils.py:304-352).  The reference limits
        this to the lookahead over-selection because its host two-
        pointer kernel is expensive; the dense device kernel here is
        cheap enough to also tighten every remaining *contender* pair
        (lower bound under the endpoint threshold), which directly
        improves the next iteration's clipped predictions and
        thresholds.  Chunked with the reference's wall-clock bailout
        (reference annchor.py:511)."""
        if self._dev is not None:
            self._dev.tighten()
            return
        contenders = self._contender_ids()
        extra = contenders[
            ~np.isin(contenders, self.nextback, assume_unique=True)
        ]
        todo = np.concatenate([self.nextback, extra])
        if todo.shape[0] == 0:
            return
        start = time.time()
        for s in range(0, todo.shape[0], chunk_size):
            nb = todo[s : s + chunk_size]
            lb_new, ub_new = tighten_bounds(
                self.nx,
                self.IJs,
                self.RefineApprox,
                self.not_computed_mask,
                self.IJs[nb],
                self.features[nb, 0],
                self.features[nb, 1],
            )
            self.features[nb, 0] = lb_new
            self.features[nb, 1] = ub_new
            if time.time() - start > timeout:
                break

    def finalise_bounds(self, timeout=10):
        """Post-refinement tightening: after the last exact batch lands
        there is one more chance to squeeze the never-computed pairs'
        bounds (the reference stops tightening before the final
        iteration, so late over-predictions keep their stale estimate).
        Clips RefineApprox into the tightened interval so graph
        assembly ranks pending pairs with the best available bound
        information.  Metric spaces only — without the triangle
        inequality the interval is not a bound."""
        if not self.is_metric:
            return
        if self._dev is not None:
            self._dev.finalise()
            return
        if not hasattr(self, "thresh"):
            return
        # fresh thresholds: the last refinement batch has landed since
        # select_refine computed self.thresh
        self.thresh = np.asarray(
            pair_ops.kth_smallest_per_point(
                self.RefineApprox, self.P_idx, self.n_neighbors
            ),
            dtype=np.float64,
        )
        contenders = self._contender_ids()
        if contenders.shape[0] == 0:
            return
        lb_new, ub_new = tighten_bounds(
            self.nx,
            self.IJs,
            self.RefineApprox,
            self.not_computed_mask,
            self.IJs[contenders],
            self.features[contenders, 0],
            self.features[contenders, 1],
        )
        self.features[contenders, 0] = lb_new
        self.features[contenders, 1] = ub_new
        self.RefineApprox[contenders] = np.clip(
            self.RefineApprox[contenders], lb_new, ub_new
        )

    def _certify(self, ngi, ngd):
        """Exact re-evaluation of the scout-built candidate graph, then
        scout-screened graph expansion.

        Pass 1: the scout metric selected `k-1+certify_pad` candidates
        per point; the exact metric scores the (deduplicated) candidate
        edges and each row keeps its exact top k-1.

        Expansion: a missed true neighbour is almost always a
        graph-neighbour of a found one but can sit arbitrarily deep in
        the scout *ranking* (the deep candidates carry regression
        predictions, not scout values).  So each round takes the
        neighbours-of-neighbours of the current exact top lists,
        scout-evaluates them fresh (cheap, batched), and exactly
        evaluates only those whose scout value could beat a row's exact
        kth distance — the admission margin is calibrated from the
        scout-vs-exact residuals measured on the pass-1 edges.  Exact
        cost stays a few percent of p_work*N; measured on the
        digits_large stand-in this cuts errors 29 -> ~2."""
        nx, nsel = ngi.shape
        kk = self.n_neighbors - 1

        rows = np.repeat(np.arange(nx, dtype=np.int64), nsel)
        cols = ngi.reshape(-1).astype(np.int64)
        valid = (cols >= 0) & (cols != rows)
        key = (
            np.minimum(rows, cols) * nx + np.maximum(rows, cols)
        )[valid]
        uniq = np.unique(key)
        IJ = np.stack([uniq // nx, uniq % nx], axis=1)
        # dispatch the scout values for the same edges FIRST (async
        # device work), run the serial host exact-EMD batch while the
        # device computes, then download once — the margin calibration
        # needs both, and this overlaps the two longest certify stages
        scout_dev = None
        scout = getattr(self.metric, "scout", None)
        if scout is not None and hasattr(scout, "dispatch"):
            scout_dev, _m = scout.dispatch(self.X, self.X, IJ)
        exact = np.asarray(
            self._exact_eval(self.f, self.X, IJ), dtype=np.float64
        )
        self.evals += exact.shape[0]

        if scout_dev is not None:
            scout_d = np.asarray(scout_dev, dtype=np.float64)[: IJ.shape[0]]
            self.scout_evals += IJ.shape[0]
        else:
            scout_d = self._eval_pairs(IJ)
        lo = float(np.quantile(exact - scout_d, 0.001)) - 1e-3

        seen = uniq
        pool_keys = uniq
        pool_vals = exact

        def row_topk():
            a = pool_keys // nx
            b = pool_keys % nx
            pr = np.concatenate([a, b])
            pc = np.concatenate([b, a])
            pv = np.concatenate([pool_vals, pool_vals])
            order = np.lexsort((pv, pr))
            pr_s = pr[order]
            starts = np.searchsorted(pr_s, np.arange(nx))
            rank = np.arange(pr_s.shape[0]) - starts[pr_s]
            sel = rank < kk
            gi = np.full((nx, kk), -1, dtype=np.int64)
            gd = np.full((nx, kk), np.inf)
            gi[pr_s[sel], rank[sel]] = pc[order][sel]
            gd[pr_s[sel], rank[sel]] = pv[order][sel]
            return gi, gd

        cap = self.certify_expand_cap
        if cap is None:
            cap = 32 * nx
        for _ in range(self.certify_expand_rounds):
            gi, gd = row_topk()
            kth = gd[:, -1]
            vi, vj = np.nonzero(gi >= 0)
            j = gi[vi, vj]
            ri = np.repeat(vi, kk)
            ci = gi[j].reshape(-1)
            ok = (ci >= 0) & (ci != ri)
            ek = np.minimum(ri, ci) * nx + np.maximum(ri, ci)
            new = np.setdiff1d(
                np.unique(ek[ok]), seen, assume_unique=True
            )
            if new.size == 0:
                break
            a = new // nx
            b = new % nx
            sdn = self._eval_pairs(np.stack([a, b], axis=1))
            margin = sdn + lo - np.maximum(kth[a], kth[b])
            admit = np.flatnonzero(margin <= 0.0)
            if admit.size > cap:
                admit = admit[
                    np.argpartition(margin[admit], cap)[:cap]
                ]
            seen = np.union1d(seen, new)
            if admit.size == 0:
                continue
            ex = np.asarray(
                self._exact_eval(
                    self.f, self.X, np.stack([a[admit], b[admit]], axis=1)
                ),
                dtype=np.float64,
            )
            self.evals += ex.shape[0]
            pool_keys = np.concatenate([pool_keys, new[admit]])
            pool_vals = np.concatenate([pool_vals, ex])
        return row_topk()

    def get_ann(self):
        """Assemble the k-NN graph, self-prepended
        (reference annchor.py:514-530).  Hybrid fits over-select by
        certify_pad and re-rank the rows with exact distances."""
        nsel = self.n_neighbors - 1
        if self._scouting:
            nsel += self.certify_pad
        if self._dev is not None:
            ngi, ngd = self._dev.knn_graph(nsel)
            ng_exact = self._dev.ng_exact_mask
        else:
            ngi, ngd, pair_ids = pair_ops.knn_from_pairs(
                self.RefineApprox,
                self.IJs,
                self.P_idx,
                self.not_computed_mask,
                nsel,
            )
            m = self.IJs.shape[0]
            valid = pair_ids < m
            ng_exact = valid & ~self.not_computed_mask[
                np.clip(pair_ids, 0, m - 1)
            ]
        if self._scouting:
            ngi, ngd = self._certify(ngi, ngd)
            # certify re-ranked every reported edge exactly
            ng_exact = np.ones(ngi.shape, dtype=bool)
        # per-edge exactness (col 0 = self, exact by construction):
        # refine_neighbor_graph certifies predicted edges first
        self._ng_exact = np.concatenate(
            [np.ones((self.nx, 1), dtype=bool), ng_exact[:, : ngi.shape[1]]],
            axis=1,
        )
        self.neighbor_graph = (
            np.concatenate(
                [np.arange(self.nx)[:, None], ngi], axis=1
            ),
            np.concatenate([np.zeros((self.nx, 1)), ngd], axis=1),
        )

    def fit(self):
        """Computes the approximate nearest neighbour graph.

        With verbose=True prints the reference's stage-timer table
        (reference annchor.py:538-543) extended with the per-stage
        metric-call count; with trace_dir set, the whole fit runs
        under a jax.profiler trace for TensorBoard/XProf inspection
        (SURVEY.md §5 tracing)."""
        if self.trace_dir is not None:
            import jax

            with jax.profiler.trace(self.trace_dir):
                return self._fit_impl()
        return self._fit_impl()

    def _fit_impl(self):
        evals_seen = [self.evals]

        def timeit(item, origin, start):
            d_evals = self.evals - evals_seen[0]
            evals_seen[0] = self.evals
            print(
                "%40s: %6.3f | %7.3f | %7d evals"
                % (item, time.time() - start, time.time() - origin, d_evals)
            )

        origin = time.time()
        stages = [
            ("get_anchors", self.get_anchors),
            ("get_locality", self.get_locality),
            ("get_features", self.get_features),
        ]
        for name, fn in stages:
            start = time.time()
            if self.verbose:
                print(f"computing {name}...")
            fn()
            if self.verbose:
                timeit(name, origin, start)

        niters = self.niters
        for it in range(niters):
            start = time.time()
            try:
                self.get_sample()
            except NothingToSample as err:
                if it == 0:
                    ncm = np.asarray(self.not_computed_mask)
                    remaining = int(ncm.sum())
                    budget = int(self._p_work_fit * self.N - self.na)
                    if remaining == 0 or remaining <= budget:
                        # tiny datasets: the stratified sampler cannot
                        # draw (pool // 10 == 0), but the whole pool
                        # fits the eval budget — evaluate it outright
                        # and assemble the exact graph instead of
                        # failing (the reference raises here)
                        if remaining:
                            ids = np.flatnonzero(ncm).astype(np.int64)
                            if self._dev is not None:
                                d = self._eval_pairs(
                                    self._dev._pairs_at(ids)
                                )
                                self._dev.apply_exact(ids, d)
                            else:
                                d = self._eval_pairs(self.IJs[ids])
                                self.RefineApprox[ids] = d
                                self.not_computed_mask[ids] = False
                        if self._dev is not None:
                            # the regression predict never ran, so
                            # device RA is still zeros for the
                            # anchor-exact pairs
                            self._dev.seed_ra_from_store()
                        print(
                            "Warning: nothing to sample — evaluated "
                            + "the remaining %d candidate pairs "
                            % remaining
                            + "exactly."
                        )
                        break
                    raise ValueError(
                        "Sampler raised NothingToSample on first iteration."
                    ) from err
                print(
                    "Warning: main loop terminated early with nothing "
                    + "left to sample."
                )
                break
            finally:
                if self.verbose:
                    timeit("get_sample", origin, start)

            for name, fn in [
                ("fit_predict_regression", self.fit_predict_regression),
                ("fit_predict_errors", self.fit_predict_errors),
            ]:
                start = time.time()
                fn()
                if self.verbose:
                    timeit(name, origin, start)

            start = time.time()
            self.select_refine_candidate_pairs(w=1 / niters, it=it)
            if self.verbose:
                timeit("select_refine_candidate_pairs", origin, start)

            if it < niters - 1:
                start = time.time()
                self.update_anchor_points()
                if self.verbose:
                    timeit("update_anchor_points", origin, start)

        start = time.time()
        self.finalise_bounds()
        if self.verbose:
            timeit("finalise_bounds", origin, start)

        start = time.time()
        self.get_ann()
        if self.verbose:
            timeit("get_ann", origin, start)

        if self.refine_frac > 0 and not self._scouting:
            # spend the held-back refine_frac share of p_work on
            # post-fit graph-expansion refinement (same total budget)
            start = time.time()
            self.refine_neighbor_graph(rounds=self.refine_rounds)
            if self.verbose:
                timeit("refine_neighbor_graph", origin, start)

    def refine_neighbor_graph(self, rounds=2, budget=None):
        """Post-fit graph-expansion refinement: certify the
        reported-but-predicted edges, then spend the remaining budget
        on triangle-screened 2-hop candidates (annchor_tpu.refine).
        Default budget = the unspent p_work allowance, so the default
        call never exceeds the fit's eval contract.  Recovers true
        edges outside the candidate set — recall past the locality
        filter's / pair budget's coverage ceiling."""
        from annchor_tpu.refine import refine_neighbor_graph

        return refine_neighbor_graph(self, rounds=rounds, budget=budget)

    def to_sparse_matrix(self):
        """k-NN graph as a symmetrised scipy dok_matrix with +eps so
        UMAP 'precomputed' treats stored zeros as edges
        (reference annchor.py:625-641)."""
        from scipy.sparse import dok_matrix

        D = dok_matrix((self.nx, self.nx), dtype=np.float64)
        eps = np.nextafter(0, 1, dtype=np.float64)
        for i, (js, ds) in enumerate(zip(*self.neighbor_graph)):
            for j, d in zip(js, ds):
                D[i, j] = D[j, i] = d + eps
        return D

    def query(self, Q, nn=15, p_work=0.3, get_exact_query_ijs=None,
              loc_thresh=None, locality=None, seed_frac=0.5,
              expand_rounds=3):
        """Query new points against the fitted index
        (reference annchor.py:643-683).

        loc_thresh/locality (extension) override the fitted filter
        knobs for query-side candidate generation only — widen the
        query candidate pool of a selectively-tuned scale index
        without refitting; the eval budget stays p_work.
        seed_frac/expand_rounds (extension) split the budget between
        the error-model seed and the graph-expansion walk."""
        from annchor_tpu.query import query_

        nq = len(Q)
        na = self.n_anchors * nq
        nbf = nq * self.nx
        limit = ((nq * nn * 3) // 2 - 1 + na) / nbf
        if p_work < limit:
            print("Warning: p_work too low")
            print("Increasing p_work to %5.3f" % limit)
            p_work = limit
        return query_(
            self, Q, nn=nn, p_work=p_work,
            get_exact_query_ijs=get_exact_query_ijs,
            loc_thresh=loc_thresh, locality=locality,
            seed_frac=seed_frac, expand_rounds=expand_rounds,
        )

    def save(self, path, include_exact=True):
        """Persist the fitted index (see annchor_tpu.io; the dataset
        and metric are re-supplied at load time).  Scale-path fits are
        saved scale-safe (format v2: no O(m) host materialisation);
        include_exact=False drops the exact-store dump there."""
        from annchor_tpu.io import save_annchor

        save_annchor(self, path, include_exact=include_exact)

    @classmethod
    def load(cls, path, X, func, func_kwargs=None, **kwargs):
        """Rebuild a fitted index saved with save().  For scale-path
        (v2) checkpoints, rebuild_pairs=True re-runs the device pair
        build from the stored anchor columns (no metric calls)."""
        from annchor_tpu.io import load_annchor

        return load_annchor(
            path, X, func, func_kwargs=func_kwargs, **kwargs
        )

    def legacy_query(
        self, Z, k=5, alpha=1.4, beta=1.4, get_exact_query_ijs=None
    ):
        """Older landmark-descent query (reference
        query_functions.py:218-338; kept for parity — the reference
        ships it unwired to the public API)."""
        from annchor_tpu.query import legacy_query_

        return legacy_query_(
            self,
            Z,
            get_exact_query_ijs=get_exact_query_ijs,
            k=k,
            alpha=alpha,
            beta=beta,
        )

    def get_nearest_enemies(self, y, nn=3, loc_min=100):
        from annchor_tpu.enemies import get_nearest_enemies

        return get_nearest_enemies(self, y, nn=nn, loc_min=loc_min)

    def annchor_selective_subset(self, y, dne=None, alpha=0):
        from annchor_tpu.enemies import annchor_selective_subset

        return annchor_selective_subset(self, y, dne=dne, alpha=alpha)

    def alpha_rss(self, y, dne=None, alpha=0):
        from annchor_tpu.enemies import alpha_rss

        return alpha_rss(self, y, dne=dne, alpha=alpha)


class BruteForce:
    """Exact k-NN graph through the same metric backend
    (reference annchor.py:943-1023)."""

    def __init__(
        self,
        X,
        func,
        func_kwargs=None,
        verbose=False,
        get_exact_ijs=None,
        backend=None,
    ):
        self.X = X
        self.nx = len(X)
        self.metric = get_function_from_input(func, func_kwargs)
        self.f = self.metric.scalar
        self.verbose = verbose
        if get_exact_ijs is None:
            self.get_exact_ijs = make_get_exact_ijs(
                self.metric, verbose=verbose, backend=backend
            )
        else:
            self.get_exact_ijs = get_exact_ijs
        test_parallelisation(self.get_exact_ijs, self.f, self.X, self.nx, s=20)

    def fit(self):
        nx = self.nx
        iu = np.triu_indices(nx, k=1)
        IJs = np.stack([iu[0], iu[1]], axis=1)
        dists = np.asarray(
            self.get_exact_ijs(self.f, self.X, IJs), dtype=np.float64
        )
        D = np.zeros((nx, nx))
        D[iu] = dists
        D += D.T
        self.D = D
        self.neighbor_graph = (
            np.argsort(D, axis=1, kind="stable"),
            np.sort(D, axis=1, kind="stable"),
        )


def compare_neighbor_graphs(nng_1, nng_2, n_neighbors):
    """Number of incorrect NN pairs between two k-NN graphs, compared
    as multisets of distances rounded to 3 decimals so equidistant
    neighbours never count as errors (reference annchor.py:1026-1066).

    Note the reference counts the number of *distinct* over-represented
    rounded values per row (len of the Counter difference), which this
    reproduces exactly.
    """
    # + 0.0 maps any -0.0 to +0.0 so the uint32 bit pattern of equal
    # rounded values is identical; nonnegative IEEE floats then sort
    # identically as bits, letting the whole per-row Counter
    # difference run as flat sorted-array ops (the reference's Python
    # row loop costs ~14 s at 100k rows; this is ~2 s)
    d1 = (
        np.round(np.asarray(nng_1[1])[:, :n_neighbors], 3)
        .astype(np.float32) + 0.0
    )
    d2 = (
        np.round(np.asarray(nng_2[1])[:, :n_neighbors], 3)
        .astype(np.float32) + 0.0
    )
    # the reference zips rows, silently comparing the common prefix
    # when the graphs differ in length — keep that semantics
    nx = min(d1.shape[0], d2.shape[0])
    d1, d2 = d1[:nx], d2[:nx]

    def row_keys(d):
        bits = np.ascontiguousarray(d).view(np.uint32).astype(np.int64)
        row = np.repeat(
            np.arange(nx, dtype=np.int64), d.shape[1]
        )
        return np.sort(row * (1 << 32) + bits.ravel())

    k1 = row_keys(d1)
    k2 = row_keys(d2)
    first = np.ones(k1.shape[0], dtype=bool)
    first[1:] = k1[1:] != k1[:-1]
    uk = k1[first]
    starts = np.flatnonzero(first)
    ac = np.diff(np.append(starts, k1.shape[0]))
    cb = np.searchsorted(k2, uk, "right") - np.searchsorted(k2, uk, "left")
    # reference semantics: per row, the number of DISTINCT rounded
    # values over-represented in graph 1 vs graph 2
    return int(np.sum(ac > cb))
