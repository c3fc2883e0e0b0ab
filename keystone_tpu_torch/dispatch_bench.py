"""Dispatch accounting for the example pipelines: programs a run, and on
the card the kernels, graph replays and synchronizing calls behind them.

Counterpart of `keystone_tpu/dispatch_bench.py:1-475`: `PLANS` (`:56`),
the four `EXAMPLES` (`:69-206`, the same numpy seeds and sizes),
`_plan_context` (`:212-262`), `measure_example` (`:296-348`),
`dispatch_count_report` (`:351-467`) and `_kind_counts`. Each example runs
from a clean `PipelineEnv` under each plan:

  - ``serial_unfused``: no fusion, no overlap, no concurrent dispatch;
  - ``legacy``: transformer-chain fusion only (``fuse_apply=False``);
  - ``optimized``: fusion through the estimators' apply boundaries and
    concurrent dispatch, megafusion off;
  - ``megafused``: ``optimized`` plus `MegafusionRule` (the default
    plan): a fitted apply path is one padded chunk loop, one CUDA graph
    replay once captured;
  - ``precision``: ``megafused`` plus the precision planner with its
    floor at 0, its outputs held to the declared band
    (`analysis/precision.py::DEFAULT_BAND_*`), not to equality;
  - ``kernel``: ``megafused`` plus the unified planner with its floor at
    0, so its kernel axis tags the chain kernel's slice. JAX's
    interpret-mode hook (`_chain_kernel_interpret`, `:269-293`) has no
    counterpart and the plan sets no environment variable: on the card
    K4 launches where the plan tags it, on the CPU its plain version
    runs.

A measurement reports the fit run (the first application: the fits and
the training apply) and the apply run (the fitted pipeline on held-out
rows, the serving path) apart. Beside JAX's program counts
(``dispatch.programs_executed``) it reports what ran on the device, as
deltas: the kernels' ``launches`` (K1 `conv_rectify_pool`, K4
`elementwise_chain`, K5 `rbf_block`), ``megafusion.graph_replays``, and
the calls that waited for the card (torch's sync debug mode; none on
the CPU). `measure_example` takes ``device``: the examples draw their
arrays with numpy and put them there. The default ``"cuda"`` raises
without a card.

    python -m keystone_tpu_torch.dispatch_bench [--device cpu] [NAME ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np

from .device import DeviceLike, resolve_device

PLANS = ("serial_unfused", "legacy", "optimized", "megafused",
         "precision", "kernel")


# ---------------------------------------------------------------- examples
#
# Small instances of the example pipelines of `analysis/examples.py`,
# data-identical to JAX's. Builders take the device and return
# (predictor, train_data, test_data): applying `predictor` to train_data
# is the fit run, to test_data the apply run.


def _build_mnist_random_fft(device):
    """MnistRandomFFT (`pipelines/mnist_random_fft.py`): a gather of
    RandomSign → PaddedFFT → LinearRectifier branches → VectorCombiner →
    BlockLeastSquares → MaxClassifier."""
    from .data.dataset import Dataset
    from .nodes.learning import BlockLeastSquaresEstimator
    from .nodes.stats import LinearRectifier, PaddedFFT, RandomSignNode
    from .nodes.util import (
        ClassLabelIndicatorsFromInt,
        MaxClassifier,
        VectorCombiner,
    )
    from .workflow import Pipeline

    rng = np.random.default_rng(0)
    dim, n_train, n_test, k = 32, 64, 32, 6
    X = rng.normal(size=(n_train, dim)).astype(np.float32)
    Xt = rng.normal(size=(n_test, dim)).astype(np.float32)
    y = rng.integers(0, k, n_train).astype(np.int32)

    branches = [
        RandomSignNode(dim, seed=i, device=device) >> PaddedFFT()
        >> LinearRectifier(0.0)
        for i in range(3)
    ]
    featurizer = Pipeline.gather(branches) >> VectorCombiner()
    train = Dataset(X, device=device)
    labels = ClassLabelIndicatorsFromInt(k)(Dataset(y, device=device)).get()
    predictor = featurizer.and_then(
        BlockLeastSquaresEstimator(dim, num_iter=1, lam=1e-2), train, labels
    ) >> MaxClassifier()
    return predictor, train, Dataset(Xt, device=device)


def _build_random_patch_cifar(device):
    """RandomPatchCifar's prediction path (the ``analyzable()`` graph):
    conv → rectify → pool → vectorize → Cacher → StandardScaler →
    BlockLeastSquares → argmax, with random filters in place of the
    learned ones. The fusion pass's peephole runs the first three as K1."""
    from .data.dataset import Dataset
    from .nodes.images.core import (
        Convolver,
        ImageVectorizer,
        PixelScaler,
        Pooler,
        SymmetricRectifier,
    )
    from .nodes.learning import BlockLeastSquaresEstimator
    from .nodes.stats import StandardScaler
    from .nodes.util import Cacher, ClassLabelIndicatorsFromInt, MaxClassifier

    rng = np.random.default_rng(1)
    h = w = 16
    c, nf, k = 3, 8, 4
    X = rng.uniform(0, 255, size=(48, h, w, c)).astype(np.float32)
    Xt = rng.uniform(0, 255, size=(24, h, w, c)).astype(np.float32)
    y = rng.integers(0, k, 48).astype(np.int32)
    filters = rng.normal(size=(nf, 4 * 4 * c)).astype(np.float32)

    featurizer = (
        PixelScaler().to_pipeline()
        >> Convolver(filters, h, w, c, whitener=None, device=device)
        >> SymmetricRectifier(alpha=0.25)
        >> Pooler(6, 7, pool_fn="sum")
        >> ImageVectorizer()
        >> Cacher("features")
    )
    train = Dataset(X, device=device)
    labels = ClassLabelIndicatorsFromInt(k)(Dataset(y, device=device)).get()
    predictor = (
        featurizer.and_then(StandardScaler(), train)
        .and_then(BlockLeastSquaresEstimator(64, 1, 1.0), train, labels)
        >> MaxClassifier()
    )
    return predictor, train, Dataset(Xt, device=device)


def _build_timit(device):
    """TimitPipeline (`pipelines/timit.py`): CosineRandomFeatures →
    Cacher → BlockLeastSquares → MaxClassifier over featurized frames."""
    from .data.dataset import Dataset
    from .nodes.learning import BlockLeastSquaresEstimator
    from .nodes.stats import CosineRandomFeatures
    from .nodes.util import Cacher, ClassLabelIndicatorsFromInt, MaxClassifier

    rng = np.random.default_rng(2)
    dim, nf, k = 24, 48, 6
    X = rng.normal(size=(64, dim)).astype(np.float32)
    Xt = rng.normal(size=(32, dim)).astype(np.float32)
    y = rng.integers(0, k, 64).astype(np.int32)

    featurizer = (
        CosineRandomFeatures(dim, nf, gamma=0.05, seed=0,
                             device=device).to_pipeline()
        >> Cacher("timit-features")
    )
    train = Dataset(X, device=device)
    labels = ClassLabelIndicatorsFromInt(k)(Dataset(y, device=device)).get()
    predictor = featurizer.and_then(
        BlockLeastSquaresEstimator(nf, num_iter=1, lam=1e-3), train, labels
    ) >> MaxClassifier()
    return predictor, train, Dataset(Xt, device=device)


def _build_linear_pixels(device):
    """LinearPixels (`pipelines/cifar_variants.py`): PixelScaler →
    GrayScaler → ImageVectorizer → BlockLeastSquares → argmax. The
    featurizer's trail is the chain kernel's (K4) family."""
    from .data.dataset import Dataset
    from .nodes.images.core import GrayScaler, ImageVectorizer, PixelScaler
    from .nodes.learning import BlockLeastSquaresEstimator
    from .nodes.util import ClassLabelIndicatorsFromInt, MaxClassifier

    rng = np.random.default_rng(3)
    h = w = 8
    c, k = 3, 4
    X = rng.uniform(0, 255, size=(48, h, w, c)).astype(np.float32)
    Xt = rng.uniform(0, 255, size=(24, h, w, c)).astype(np.float32)
    y = rng.integers(0, k, 48).astype(np.int32)

    featurizer = (PixelScaler().to_pipeline() >> GrayScaler()
                  >> ImageVectorizer())
    train = Dataset(X, device=device)
    labels = ClassLabelIndicatorsFromInt(k)(Dataset(y, device=device)).get()
    predictor = featurizer.and_then(
        BlockLeastSquaresEstimator(h * w, num_iter=1, lam=1e-2), train,
        labels) >> MaxClassifier()
    return predictor, train, Dataset(Xt, device=device)


#: name (as in `analysis/examples.py`) -> builder(device)
EXAMPLES: Dict[str, Callable] = {
    "MnistRandomFFT": _build_mnist_random_fft,
    "RandomPatchCifar": _build_random_patch_cifar,
    "TimitPipeline": _build_timit,
    "LinearPixels": _build_linear_pixels,
}


# ------------------------------------------------------------- measurement


def _plan_context(plan: str):
    """(optimizer, overlap on, concurrent dispatch on, config overrides)
    of a named plan (`:212-262`), over `workflow/optimizer.py`'s
    `DefaultOptimizer` and `workflow/env.py`'s `config_override`. The
    plans before ``precision`` pin the planners that postdate them off,
    every plan but ``kernel`` pins the unified planner off, and
    ``precision`` and ``kernel`` drop their planner's floor to 0 so that
    these small instances plan."""
    from .workflow.optimizer import DefaultOptimizer

    if plan == "serial_unfused":
        return DefaultOptimizer(fuse=False, sharding_planner=False,
                                precision_planner=False,
                                unified_planner=False), \
            False, False, dict(megafusion=False, precision_planner=False,
                               unified_planner=False)
    if plan == "legacy":
        return DefaultOptimizer(fuse_apply=False, sharding_planner=False,
                                precision_planner=False,
                                unified_planner=False), \
            True, False, dict(megafusion=False, precision_planner=False,
                              unified_planner=False)
    if plan == "optimized":
        return DefaultOptimizer(megafuse=False, sharding_planner=False,
                                precision_planner=False,
                                unified_planner=False), \
            True, True, dict(megafusion=False, precision_planner=False,
                             unified_planner=False)
    if plan == "megafused":
        return DefaultOptimizer(precision_planner=False,
                                unified_planner=False), True, True, \
            dict(megafusion=True, precision_planner=False,
                 unified_planner=False)
    if plan == "precision":
        return DefaultOptimizer(unified_planner=False), True, True, \
            dict(megafusion=True, precision_planner=True,
                 precision_min_savings_bytes=0, unified_planner=False)
    if plan == "kernel":
        return DefaultOptimizer(precision_planner=False), True, True, \
            dict(megafusion=True, precision_planner=False,
                 unified_planner=True, unified_min_savings_seconds=0.0)
    raise ValueError(f"unknown plan {plan!r}; expected one of {PLANS}")


#: the kernels of the examples' path: K1, K4 and K5
PATH_KERNELS = ("conv_rectify_pool", "elementwise_chain", "rbf_block")


def _device_run(fn, device) -> Tuple[np.ndarray, Dict[str, int]]:
    """(the run's predictions on the host, what it dispatched): the
    programs executed, the kernels' launches, the graph replays and the
    synchronizing calls, as deltas over the run."""
    from .telemetry import metrics_delta
    from .utils.profiling import count_syncs, launch_counts

    before = launch_counts()
    box = []
    with metrics_delta() as d:
        if device.type == "cuda":
            _, syncs = count_syncs(lambda: box.append(fn().get()))
        else:  # no call waits on the CPU
            box.append(fn().get())
            syncs = 0
    out = box[0]
    pred = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    after = launch_counts()
    counts = {"programs": int(d.counter("dispatch.programs_executed")),
              "graph_replays": int(d.counter("megafusion.graph_replays")),
              "syncs": int(syncs)}
    counts.update({k: int(after[k] - before[k]) for k in PATH_KERNELS})
    return np.asarray(pred), counts


def measure_example(name: str, plan: str, device: DeviceLike = "cuda"
                    ) -> Dict:
    """Run one example under one plan from a clean `PipelineEnv`
    (`:296-348`): the program counts of both runs, what each dispatched
    on the device, both runs' predictions on the host, and the
    decisions the optimizer recorded in the window."""
    from .telemetry import current_tracer, ledger
    from .workflow.env import (
        PipelineEnv,
        config_override,
        dispatch_override,
        overlap_override,
    )

    device = resolve_device(device)
    optimizer, overlap_on, concurrent_on, overrides = _plan_context(plan)
    PipelineEnv.reset()
    mark = ledger.session_mark()
    try:
        PipelineEnv.get().set_optimizer(optimizer)
        with overlap_override(overlap_on), \
                dispatch_override(concurrent_on), \
                config_override(**overrides):
            predictor, train, test = EXAMPLES[name](device)
            train_pred, fit_counts = _device_run(
                lambda: predictor(train), device)
            test_pred, apply_counts = _device_run(
                lambda: predictor(test), device)
    finally:
        PipelineEnv.reset()
    decisions = ledger.session_since(mark)
    tracer = current_tracer()
    if tracer is not None:
        # the per-plan breakdown in the trace's metadata, which
        # `telemetry/export.py::dispatch_plan_breakdown` renders
        meta = tracer.metadata.setdefault(
            "dispatch_plans",
            {"plans": list(PLANS), "apply_run_programs": {}})
        meta["apply_run_programs"].setdefault(name, {})[plan] = int(
            apply_counts["programs"])
    return {
        "plan": plan,
        "fit_run_programs": fit_counts["programs"],
        "apply_run_programs": apply_counts["programs"],
        "fit_run_device": fit_counts,
        "apply_run_device": apply_counts,
        "train_pred": train_pred,
        "test_pred": test_pred,
        "decisions": decisions,
    }


def dispatch_count_report(
    examples: Tuple[str, ...] = ("MnistRandomFFT", "RandomPatchCifar",
                                 "TimitPipeline"),
    device: DeviceLike = "cuda",
) -> Dict:
    """Programs a run per example and plan, the reductions of the apply
    run against the other plans (the headline plan is ``megafused``),
    and JAX's three verdicts (`:351-467`): the other plans' outputs
    against ``serial_unfused`` within 1e-5 (``all_outputs_match``),
    ``precision``'s within the declared band (``precision_in_band``),
    and a megafused apply run of one program recorded as such in the
    ledger (``decisions_reconciled``). Each example also carries the
    device counts of every plan's runs (``device``)."""
    from .analysis.precision import DEFAULT_BAND_ATOL, DEFAULT_BAND_RTOL
    from .telemetry.ledger import decision_key

    out: Dict = {"examples": {}, "plans": list(PLANS),
                 "plan_breakdown": []}
    reductions: List[float] = []
    mega_one = 0
    precision_in_band = True
    decisions_reconciled = True
    for name in examples:
        runs = {plan: measure_example(name, plan, device=device)
                for plan in PLANS}
        base = runs["serial_unfused"]
        mega = runs["megafused"]
        outputs_match = True
        in_band = True
        for r in (runs["legacy"], runs["optimized"], mega,
                  runs["kernel"]):
            for side in ("train_pred", "test_pred"):
                if not np.allclose(r[side], base[side], rtol=1e-5,
                                   atol=1e-5):
                    outputs_match = False
        # bf16 boundaries round, so the precision plan is held to
        # the declared band; its argmax outputs are integers, where
        # the band is equality with a small tie-flip allowance
        for side in ("train_pred", "test_pred"):
            a, b = runs["precision"][side], base[side]
            if np.issubdtype(a.dtype, np.integer):
                if np.mean(a == b) < 0.95:
                    in_band = False
            elif not np.allclose(a, b, rtol=DEFAULT_BAND_RTOL,
                                 atol=DEFAULT_BAND_ATOL):
                in_band = False
        precision_in_band &= in_band
        apply_ratio = (base["apply_run_programs"] / mega["apply_run_programs"]
                       if mega["apply_run_programs"] else float("inf"))
        reductions.append(apply_ratio)
        mega_one += int(mega["apply_run_programs"] == 1)
        # a megafused apply run of one program must have been recorded,
        # and predicted, as exactly that
        mega_uniq: Dict = {}
        for d in mega.get("decisions") or []:
            if d.get("kind") == "megafusion":
                mega_uniq.setdefault(decision_key(d), d)
        ex_reconciled = bool(
            mega["apply_run_programs"] != 1 or (
                mega_uniq and all(
                    (d.get("predicted") or {}).get("programs_per_apply") == 1
                    for d in mega_uniq.values())))
        decisions_reconciled &= ex_reconciled
        out["examples"][name] = {
            "apply_run_programs": {
                p: runs[p]["apply_run_programs"] for p in PLANS},
            "fit_run_programs": {
                p: runs[p]["fit_run_programs"] for p in PLANS},
            "reduction_vs_serial_unfused": round(apply_ratio, 2),
            "reduction_vs_legacy": round(
                runs["legacy"]["apply_run_programs"]
                / max(1, mega["apply_run_programs"]), 2),
            "reduction_vs_optimized": round(
                runs["optimized"]["apply_run_programs"]
                / max(1, mega["apply_run_programs"]), 2),
            "outputs_match_serial_unfused": bool(outputs_match),
            "precision_in_band": bool(in_band),
            "decisions_reconciled": ex_reconciled,
            "decision_counts": {
                p: _kind_counts(runs[p].get("decisions") or [])
                for p in PLANS},
            "device": {p: {"fit": runs[p]["fit_run_device"],
                           "apply": runs[p]["apply_run_device"]}
                       for p in PLANS},
        }
        out["plan_breakdown"].append({
            "example": name,
            **{p: runs[p]["apply_run_programs"] for p in PLANS},
        })
    reductions.sort(reverse=True)
    out["examples_at_or_above_2x"] = int(sum(1 for r in reductions if r >= 2.0))
    out["examples_at_one_program"] = int(mega_one)
    out["top2_min_reduction"] = round(min(reductions[:2]), 2) if len(
        reductions) >= 2 else None
    out["all_outputs_match"] = all(
        e["outputs_match_serial_unfused"] for e in out["examples"].values())
    out["precision_in_band"] = bool(precision_in_band)
    out["decisions_reconciled"] = bool(decisions_reconciled)
    return out


def _kind_counts(decisions: List[Dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for d in decisions:
        k = str(d.get("kind"))
        out[k] = out.get(k, 0) + 1
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m keystone_tpu_torch.dispatch_bench",
        description=__doc__.splitlines()[0])
    p.add_argument("examples", nargs="*", metavar="EXAMPLE",
                   help=f"examples (default: all of {', '.join(EXAMPLES)})")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    names = tuple(args.examples or EXAMPLES)
    unknown = [n for n in names if n not in EXAMPLES]
    if unknown:
        p.error(f"unknown example(s): {', '.join(unknown)}")
    report = dispatch_count_report(names, device=args.device)
    json.dump(report, sys.stdout, indent=1, default=str)
    print()
    ok = (report["all_outputs_match"] and report["precision_in_band"]
          and report["decisions_reconciled"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
