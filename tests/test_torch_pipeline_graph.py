"""The port's typed pipeline API over the workflow graph, on the CPU.

`tests/test_pipeline.py`'s cases (reference PipelineSuite.scala,
EstimatorSuite.scala, LabelEstimatorSuite.scala) on port nodes: chaining,
laziness, single/batch parity, fit-once, incremental state reuse, CSE,
gather, `fit` pruning and save/load. Device rows use `batch_fn`
transformers; host items use `ItemTransformer`s, the port's host path.

The slice: RandomPatchCifar small, fit with `Pipeline.fit()`, saved,
loaded on the CPU and applied. The loaded pipeline's predictions equal
the in-memory pipeline's bit for bit, and its scores lie within 1e-4 of
max|score| of the JAX package's fitted pipeline on the same filters and
whitener (carried across with `convert.py`). JAX runs on a one-device
mesh, the port's layout.
"""

import jax
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.cifar_loader import synthetic_cifar as jax_synthetic
from keystone_tpu.nodes.learning import BlockLeastSquaresEstimator as JaxBCD
from keystone_tpu.nodes.stats import StandardScaler as JaxScaler
from keystone_tpu.nodes.util import (
    Cacher as JaxCacher,
    ClassLabelIndicatorsFromInt as JaxIndicators,
    MaxClassifier as JaxMax,
)
from keystone_tpu.parallel.mesh import make_mesh, use_mesh
from keystone_tpu.pipelines import random_patch_cifar as jax_rpc
from keystone_tpu.workflow import PipelineEnv as JaxPipelineEnv
from keystone_tpu_torch import convert
from keystone_tpu_torch.data.dataset import Dataset, HostDataset
from keystone_tpu_torch.loaders.cifar_loader import synthetic_cifar
from keystone_tpu_torch.nodes.images.core import Convolver
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import (
    Cacher,
    ClassLabelIndicatorsFromInt,
    MaxClassifier,
)
from keystone_tpu_torch.nodes.util.fusion import (
    FusedBatchTransformer,
    MegafusedBatchTransformer,
)
from keystone_tpu_torch.pipelines import random_patch_cifar as rpc
from keystone_tpu_torch.workflow import (
    DatasetOperator,
    Estimator,
    FittedPipeline,
    ItemTransformer,
    LabelEstimator,
    Pipeline,
    PipelineEnv,
    Transformer,
)


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


class Add(Transformer):
    def __init__(self, c):
        self.c = c

    def batch_fn(self):
        return lambda x: x + self.c


class Scale(Transformer):
    def __init__(self, c):
        self.c = c

    def batch_fn(self):
        return lambda x: x * self.c


class CountingMeanEstimator(Estimator):
    """Fits a transformer subtracting the data's mean; counts fits."""

    def __init__(self):
        self.n_fits = 0

    def fit(self, data):
        self.n_fits += 1
        return Add(-float(data.array.mean()))


class CountingLinearLabelEstimator(LabelEstimator):
    def __init__(self):
        self.n_fits = 0

    def fit(self, data, labels):
        self.n_fits += 1
        W = torch.linalg.lstsq(data.array, labels.array).solution

        class Lin(Transformer):
            def batch_fn(self):
                return lambda x: x @ W

        return Lin()


def dvec(values):
    return Dataset(np.asarray(values, dtype=np.float32), device="cpu")


def hd(values):
    return HostDataset(list(values), device="cpu")


def test_transformer_batch_and_single_parity():
    t = Add(2.0)
    np.testing.assert_allclose(t(dvec([[1.0], [2.0], [3.0]])).get().numpy(),
                               [[3.0], [4.0], [5.0]])
    assert float(t(torch.tensor(1.0)).get()) == 3.0


def test_and_then_composition_order():
    assert float(Add(1.0).and_then(Scale(10.0))(torch.tensor(2.0)).get()) \
        == 30.0
    p2 = Add(1.0) >> Scale(10.0) >> Add(5.0)
    assert float(p2(torch.tensor(0.0)).get()) == 15.0


def test_laziness_no_execution_until_get():
    calls = []

    class Tracker(Transformer):
        def batch_fn(self):
            return lambda x: calls.append(1) or x

    result = Tracker()(torch.tensor(1.0))
    assert calls == []
    result.get()
    result.get()
    assert calls == [1]


def test_estimator_fit_once_across_applies():
    est = CountingMeanEstimator()
    p = Add(0.0).and_then(est, dvec([[0.0], [2.0], [4.0]]))
    out1 = p(dvec([[1.0]])).get()
    out2 = p(dvec([[5.0]])).get()
    assert est.n_fits == 1
    np.testing.assert_allclose(out1.numpy(), [[-1.0]])
    np.testing.assert_allclose(out2.numpy(), [[3.0]])


def test_single_item_apply_reuses_fit():
    est = CountingMeanEstimator()
    p = Add(0.0).and_then(est, dvec([[0.0], [2.0], [4.0]]))
    assert float(p(torch.tensor([3.0])).get()) == 1.0
    assert float(p(torch.tensor([5.0])).get()) == 3.0
    assert est.n_fits == 1


def test_label_estimator_and_prediction():
    est = CountingLinearLabelEstimator()
    X = dvec([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    y = dvec([[2.0], [3.0], [5.0]])
    preds = Add(0.0).and_then(est, X, y)(X).get().numpy()
    np.testing.assert_allclose(preds, [[2.0], [3.0], [5.0]], atol=1e-4)
    assert est.n_fits == 1


def test_extending_pipeline_reuses_fitted_state():
    est = CountingMeanEstimator()
    base = Add(0.0).and_then(est, dvec([[2.0], [4.0]]))
    base(dvec([[1.0]])).get()
    out = base.and_then(Scale(2.0))(dvec([[1.0]])).get()
    assert est.n_fits == 1  # reused through the prefix table
    np.testing.assert_allclose(out.numpy(), [[-4.0]])


def test_gather_merges_branches():
    p = Pipeline.gather([Add(float(i)) for i in range(3)])
    assert [float(v) for v in p(torch.tensor(10.0)).get()] == [
        10.0, 11.0, 12.0]
    parts = p(dvec([[1.0], [2.0]])).get()
    np.testing.assert_allclose(parts.data[0].numpy(), [[1.0], [2.0]])
    np.testing.assert_allclose(parts.data[2].numpy(), [[3.0], [4.0]])


def test_fit_produces_serializable_fitted_pipeline(tmp_path):
    est = CountingMeanEstimator()
    p = Add(1.0).and_then(est, dvec([[2.0], [4.0]])).and_then(Scale(3.0))
    fitted = p.fit()
    assert isinstance(fitted, FittedPipeline) and est.n_fits == 1
    assert float(fitted(torch.tensor([3.0]))) == 0.0  # ((3+1)-4)*3
    assert est.n_fits == 1
    path = str(tmp_path / "fitted.pkl")
    fitted.save(path)
    loaded = FittedPipeline.load(path, device="cpu")
    assert float(loaded(torch.tensor([5.0]))) == 6.0
    np.testing.assert_allclose(loaded(dvec([[5.0], [1.0]])).numpy(),
                               [[6.0], [-6.0]])


def test_fit_prunes_training_branches():
    p = Add(0.0).and_then(CountingMeanEstimator(), dvec([[2.0], [4.0]]))
    fitted = p.fit()
    assert not any(isinstance(op, DatasetOperator)
                   for op in fitted.graph.operators.values())


def test_cse_merges_shared_featurization():
    calls = []

    class Tracker(Transformer):
        def apply_batch(self, data):
            calls.append(1)
            return data

    est = CountingMeanEstimator()
    train = dvec([[1.0], [3.0]])
    Tracker().to_pipeline().and_then(est, train)(train).get()
    assert est.n_fits == 1 and len(calls) == 1


def test_pipeline_env_reset_isolates_state():
    est = CountingMeanEstimator()
    train = dvec([[2.0]])
    p = Add(0.0).and_then(est, train)
    p(train).get()
    assert est.n_fits == 1
    PipelineEnv.reset()
    p(train).get()
    assert est.n_fits == 2


def test_fitted_forces_one_estimator_through_the_prefix_table():
    first, second = CountingMeanEstimator(), CountingMeanEstimator()
    train = dvec([[2.0], [4.0]])
    p = Add(0.0).and_then(first, train).and_then(second, train)
    assert p.fitted(0).c == -3.0 and first.n_fits == 1
    assert p.fitted(-1).c == 0.0 and second.n_fits == 1
    p(train).get()
    assert (first.n_fits, second.n_fits) == (1, 1)
    with pytest.raises(ValueError, match="no estimator"):
        Add(0.0).to_pipeline().fitted()


# ---- PipelineSuite.scala:115-326: incremental execution-state reuse ---------


class _CountingTriple(ItemTransformer):
    def __init__(self, counter):
        self.counter = counter

    def apply(self, x):
        self.counter[0] += 1
        return str(int(x) * 3)


class _Qub(ItemTransformer):
    def apply(self, x):
        return x + "qub"


class _QubEstimator(Estimator):
    def fit(self, data):
        return _Qub()


class _QubLabelEstimator(LabelEstimator):
    def fit(self, data, labels):
        return _Qub()


def test_incremental_state_variation_1():
    """PipelineSuite.scala:115-148: cached features are not reprocessed
    when the pipeline is extended and re-applied."""
    counter = [0]
    featurizer = _CountingTriple(counter).to_pipeline() >> Cacher()
    data = hd([32, 94, 12])
    features = featurizer(data)
    assert features.get().items == ["96", "282", "36"]
    assert counter[0] == 3
    pipe = featurizer >> _QubEstimator().with_data(features)
    out = pipe(data)
    assert out.get().items == ["96qub", "282qub", "36qub"]
    assert pipe(data).get().items == ["96qub", "282qub", "36qub"]
    assert counter[0] == 3
    test_out = pipe(hd([32, 94]))
    assert test_out.get().items == ["96qub", "282qub"]
    assert counter[0] == 5


def test_incremental_state_variation_2():
    """PipelineSuite.scala:150-192."""
    counter = [0]
    featurizer = _CountingTriple(counter).to_pipeline() >> Cacher()
    features = featurizer(hd([32, 94, 12]))
    assert features.get().items == ["96", "282", "36"]
    test_features = featurizer(hd([32, 94]))
    assert test_features.get().items == ["96", "282"]
    assert counter[0] == 5
    model = _QubEstimator().with_data(features)
    assert model(features).get().items == ["96qub", "282qub", "36qub"]
    assert model(test_features).get().items == ["96qub", "282qub"]
    assert counter[0] == 5
    datum_out = model(featurizer(2))
    assert datum_out.get() == "6qub" and datum_out.get() == "6qub"
    assert counter[0] == 6


def test_incremental_state_with_label_estimator():
    """PipelineSuite.scala:194-238."""
    counter = [0]
    featurizer = _CountingTriple(counter).to_pipeline() >> Cacher()
    data, labels = hd([32, 94, 12]), hd([64, 188, 24])
    features = featurizer(data)
    assert features.get().items == ["96", "282", "36"]
    label_features = featurizer(labels)
    assert label_features.get().items == ["192", "564", "72"]
    assert counter[0] == 6
    pipe = featurizer >> _QubLabelEstimator().with_data(features,
                                                        label_features)
    assert pipe(data).get().items == ["96qub", "282qub", "36qub"]
    assert pipe(labels).get().items == ["192qub", "564qub", "72qub"]
    assert counter[0] == 6
    assert pipe(hd([32, 94])).get().items == ["96qub", "282qub"]
    assert counter[0] == 8


def test_access_features_and_final_value():
    """PipelineSuite.scala:328-387."""
    counter = [0]
    featurizer = _CountingTriple(counter).to_pipeline() >> Cacher()
    data = hd([1, 2, 3])
    features = featurizer(data)
    preds = (featurizer >> _QubEstimator().with_data(features))(data)
    assert features.get().items == ["3", "6", "9"]
    assert preds.get().items == ["3qub", "6qub", "9qub"]
    assert counter[0] == 3


def test_incremental_state_with_and_then_chaining():
    """PipelineSuite.scala:240-326: the reference's recomputation counts."""
    t1c, t2c, e1c, e2c = [0], [0], [0], [0]

    class T1(ItemTransformer):
        def apply(self, x):
            t1c[0] += 1
            return x + "d"

    class T2(ItemTransformer):
        def apply(self, x):
            t2c[0] += 1
            return x + "e"

    def make_est(counter, suffix):
        class S(ItemTransformer):
            def apply(self, x):
                return x + suffix

        class E(Estimator):
            def fit(self, data):
                counter[0] += len(data.items)
                return S()

        return E()

    data1, data2 = hd(["h", "i", "j"]), hd(["f", "g"])
    pipe_left = (T1().to_pipeline() >> Cacher()).and_then(
        make_est(e1c, "abc"), data1)
    pipe_right = (T2().to_pipeline() >> Cacher()).and_then(
        make_est(e2c, "xyz"), data2)
    assert (t1c[0], t2c[0], e1c[0], e2c[0]) == (0, 0, 0, 0)
    assert pipe_left(data1).get().items == ["hdabc", "idabc", "jdabc"]
    assert (t1c[0], t2c[0], e1c[0], e2c[0]) == (3, 0, 3, 0)
    assert pipe_right(data2).get().items == ["fexyz", "gexyz"]
    assert (t1c[0], t2c[0], e1c[0], e2c[0]) == (3, 2, 3, 2)
    pipe = pipe_left >> pipe_right
    assert pipe(data1).get().items == ["hdabcexyz", "idabcexyz",
                                       "jdabcexyz"]
    assert (t1c[0], t2c[0], e1c[0], e2c[0]) == (3, 5, 3, 2)
    assert pipe(data2).get().items == ["fdabcexyz", "gdabcexyz"]
    assert (t1c[0], t2c[0], e1c[0], e2c[0]) == (5, 7, 3, 2)
    assert pipe("l").get() == "ldabcexyz"
    assert (t1c[0], t2c[0], e1c[0], e2c[0]) == (6, 8, 3, 2)


def test_cacher_keeps_its_input_in_the_prefix_table():
    """The cached dataset is the prefix table's entry for the Cacher's
    prefix, which `PipelineEnv.reset()` drops."""
    from keystone_tpu_torch.workflow.env import compute_prefix

    counter = [0]
    pipe = _CountingTriple(counter).to_pipeline() >> Cacher("c")
    data = hd([1, 2])
    result = pipe(data)
    kept = result.get()
    g = result.graph
    prefix = compute_prefix(g, g.get_sink_dependency(result.sink))
    assert PipelineEnv.get().state[prefix].get is kept
    PipelineEnv.reset()
    assert pipe(data).get().items == kept.items and counter[0] == 4


# ---- EstimatorSuite.scala / LabelEstimatorSuite.scala -----------------------


def test_estimator_with_data_raw_and_pipeline_data():
    class FirstAdder(Estimator):
        def fit(self, data):
            first = data.items[0]
            return Transformer.from_function(lambda x: x + first)

    class Doubler(ItemTransformer):
        def apply(self, x):
            return x * 2

    train, test = hd([32, 94, 12]), hd([42, 58, 61])
    assert FirstAdder().with_data(train)(test).get().items == [74, 90, 93]
    pipe2 = FirstAdder().with_data(Doubler().to_pipeline()(train))
    assert pipe2(test).get().items == [106, 122, 125]


def test_label_estimator_with_data_raw_and_pipeline_data():
    class SumFitter(LabelEstimator):
        def fit(self, data, labels):
            s = data.items[0] + labels.items[0]
            return Transformer.from_function(lambda x: x + s)

    class Neg(ItemTransformer):
        def apply(self, x):
            return -x

    train, labels, test = hd([10, 20]), hd([5, 6]), hd([1, 2])
    assert SumFitter().with_data(train, labels)(test).get().items == [16, 17]
    pipe2 = SumFitter().with_data(Neg().to_pipeline()(train),
                                  Neg().to_pipeline()(labels))
    assert pipe2(test).get().items == [-14, -13]


def test_gather_incremental_construction():
    """PipelineSuite.scala:429-482: gathering fitted pipelines reuses
    their fits."""
    n_fits = [0]

    class FirstAdder(Estimator):
        def fit(self, data):
            n_fits[0] += 1
            first = data.items[0]
            return Transformer.from_function(lambda x: x + first)

    class FirstSumAdder(LabelEstimator):
        def fit(self, data, labels):
            n_fits[0] += 1
            s = data.items[0] + int(labels.items[0])
            return Transformer.from_function(lambda x: x + s)

    def scale(c):
        return Transformer.from_function(lambda x: x * c)

    fit_data = hd([32, 94, 12])
    first = scale(2).to_pipeline() >> Transformer.from_function(
        lambda x: x - 3)
    second = scale(2).to_pipeline().and_then(FirstAdder(), fit_data)
    third = scale(4).to_pipeline().and_then(FirstSumAdder(), fit_data,
                                            hd(["10", "7", "14"]))
    assert n_fits[0] == 0
    assert (first(4).get(), second(4).get(), third(4).get()) == (
        5, 8 + 64, 16 + 138)
    assert n_fits[0] == 2
    gathered = Pipeline.gather([first, second, third])
    assert list(gathered(7).get()) == [
        first(7).get(), second(7).get(), third(7).get()]
    data = [13, 2, 83]
    want = [[first(x).get(), second(x).get(), third(x).get()] for x in data]
    got = [list(row) for row in gathered(hd(data)).get().items]
    assert got == want and n_fits[0] == 2


def test_save_of_a_lambda_raises_and_writes_nothing(tmp_path):
    p = Add(0.0).to_pipeline() >> Transformer.from_function(
        lambda x: x, name="inline-lambda")
    fitted = p.fit()
    path = tmp_path / "lambda.pkl"
    with pytest.raises(TypeError, match="inline-lambda"):
        fitted.save(str(path))
    assert not path.exists()


def test_load_without_a_card_needs_the_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "p.pkl")
    Add(1.0).to_pipeline().fit().save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FittedPipeline.load(path)
    assert float(FittedPipeline.load(path, device="cpu")(
        torch.tensor([1.0]))) == 2.0


# ---- the slice: RandomPatchCifar fit, saved, loaded, applied ----------------

CFG = dict(num_filters=16, block_size=64, microbatch=32, sample_patches=5000)
N_TRAIN, N_TEST = 300, 100  # a ragged last microbatch each


def _port_pipeline(train, filters, whitener, config, argmax=True):
    """`rpc.build_pipeline`'s graph over given filters and whitener."""
    featurizer = rpc.make_featurizer(filters, whitener, 32, 32, 3, config
                                     ).to_pipeline() >> Cacher("features")
    labels = ClassLabelIndicatorsFromInt(10)(train.labels).get()
    scorer = featurizer.and_then(StandardScaler(), train.data).and_then(
        BlockLeastSquaresEstimator(config.block_size, 1, config.lam),
        train.data, labels)
    return scorer >> MaxClassifier() if argmax else scorer


def _jax_scorer(jtrain, filters, whitener, config):
    featurizer = jax_rpc.make_featurizer(filters, whitener, 32, 32, 3, config
                                         ).to_pipeline() >> JaxCacher("f")
    labels = JaxIndicators(10)(jtrain.labels).get()
    return featurizer.and_then(JaxScaler(), jtrain.data).and_then(
        JaxBCD(config.block_size, num_iter=1, lam=config.lam), jtrain.data,
        labels)


@pytest.fixture(scope="module")
def slice_fit():
    """JAX's filters and its fitted scorer's test scores, on one device."""
    JaxPipelineEnv.reset()
    with use_mesh(make_mesh(jax.devices()[:1])):
        jtrain, jtest = jax_synthetic(N_TRAIN, N_TEST, noise=1.2,
                                      confusion=0.6)
        config = jax_rpc.RandomPatchCifarConfig(**CFG)
        filters, whitener = jax_rpc.learn_filters(jtrain.data, config)
        scorer = _jax_scorer(jtrain, filters, whitener, config).fit()
        scores = np.asarray(scorer(jtest.data).array)[:N_TEST]
        preds = np.asarray((scorer >> JaxMax()).to_pipeline()(jtest.data)
                           .get().array)[:N_TEST]
    JaxPipelineEnv.reset()
    return dict(filters=np.asarray(filters), whitener=whitener,
                scores=scores, preds=preds)


def test_slice_fit_save_load_apply_matches_jax(slice_fit, tmp_path):
    train, test = synthetic_cifar(N_TRAIN, N_TEST, noise=1.2, confusion=0.6,
                                  device="cpu")
    config = rpc.RandomPatchCifarConfig(**CFG)
    w = slice_fit["whitener"]
    filters = convert.to_tensor(slice_fit["filters"], "cpu")
    whitener = convert.whitener(w.whitener, w.means, "cpu")
    fitted = _port_pipeline(train, filters, whitener, config).fit()
    # the fitted form: one megafused chain of the featurizer, the fused
    # scaler, linear map and argmax that the fusion passes made of the
    # apply path, its Cacher absorbed
    ops = [fitted.graph.get_operator(n) for n in sorted(fitted.graph.nodes)]
    assert [op.label for op in ops] == [
        "Fused[Fused[PixelScaler >> Convolver >> SymmetricRectifier >> "
        "Pooler >> ImageVectorizer] >> StandardScalerModel >> "
        "BlockLinearMapper >> MaxClassifier]"]
    assert isinstance(ops[0], MegafusedBatchTransformer)
    assert isinstance(ops[0].stages[0], FusedBatchTransformer)
    assert ops[0].planned_kernel is None
    path = str(tmp_path / "rpc.pkl")
    fitted.save(path)
    loaded = FittedPipeline.load(path, device="cpu")
    in_memory = fitted.apply(test.data).numpy()
    again = loaded.apply(test.data).numpy()
    np.testing.assert_array_equal(again, in_memory)
    # the scores, against JAX's fitted scorer on the same filters
    scorer = _port_pipeline(train, filters, whitener, config,
                            argmax=False).fit()
    got = scorer.apply(test.data).numpy()
    want = slice_fit["scores"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    np.testing.assert_array_equal(in_memory, got.argmax(1))
    assert float(np.mean(in_memory == slice_fit["preds"])) >= 0.99


def test_slice_fit_featurizes_the_training_set_once(monkeypatch):
    """CSE shares the training featurization of the scaler's fit and the
    solver's fit: the featurizer runs once in `fit`."""
    train, _ = synthetic_cifar(96, 8, noise=1.2, confusion=0.6,
                               device="cpu")
    rows = []
    real = FusedBatchTransformer.apply_batch

    def counting(self, data):
        if any(isinstance(st, Convolver) for st in self.stages):
            rows.append(data.count)
        return real(self, data)

    monkeypatch.setattr(FusedBatchTransformer, "apply_batch", counting)
    rpc.build_pipeline(train, rpc.RandomPatchCifarConfig(**CFG)).fit()
    assert rows == [96]


def test_a_finished_run_frees_its_tensors_without_the_cycle_collector():
    """Once a run's result is dropped and `PipelineEnv.reset()` called,
    its tensors go at once: no reference cycle (a recursive closure over
    the executor or the graph) keeps them until a `gc.collect()`, which
    on the card would hold a warm run's features through the timed
    run's peak memory."""
    import gc
    import weakref

    est = CountingMeanEstimator()
    train = dvec(np.arange(8.0).reshape(8, 1))
    p = (Add(1.0).to_pipeline() >> Cacher("c")).and_then(est, train)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        result = p(train)
        result.get()
        (cached,) = [weakref.ref(e.get) for e in
                     PipelineEnv.get().state.values()
                     if isinstance(e.get, Dataset)]
        # a second apply splices the saved state into its plan
        again = p(dvec([[1.0]]))
        again.get()
        del result, again
        PipelineEnv.reset()
        assert cached() is None
    finally:
        if was_enabled:
            gc.enable()
