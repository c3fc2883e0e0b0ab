"""The port's linear-chain CRF tagger against the JAX package's.

`keystone_tpu_torch/nodes/nlp/crf.py` against `keystone_tpu/nodes/nlp/
crf.py` on the CPU, at small sizes: the hashed feature ids, the NLL and
its gradient at the same ``theta``, the batched Viterbi decode on JAX's
weights (carried across by `convert.crf_tagger_from_jax`), a small fit
by the port's copy of optax's L-BFGS against JAX's ``optax.lbfgs`` step
by step, and ``.npz`` files crossing between the packages. JAX runs on
a one-device mesh (ROADMAP's ground rules). Mirrors
`tests/test_crf_tagger.py`'s cases at small sizes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from keystone_tpu.nodes.nlp import crf as jcrf  # noqa: E402
from keystone_tpu.parallel.mesh import make_mesh, use_mesh  # noqa: E402
from keystone_tpu_torch.convert import crf_tagger_from_jax  # noqa: E402
from keystone_tpu_torch.nodes.learning.lbfgs import (  # noqa: E402
    DenseLBFGSwithL2,
    _Objective,
    lbfgs_minimize,
)
from keystone_tpu_torch.nodes.nlp import crf  # noqa: E402
from keystone_tpu_torch.nodes.nlp.crf import (  # noqa: E402
    LinearChainCRFTagger,
    jax_stop,
)
from keystone_tpu_torch.nodes.nlp.perceptron_tagger import (  # noqa: E402
    StructuredPerceptronTagger,
)
from keystone_tpu_torch.nodes.nlp.synthetic_corpus import (  # noqa: E402
    generate_ner_corpus,
    generate_pos_corpus,
)

BUCKETS = 1 << 12
N_TRAIN = 300
MAX_ITER = 20
#: the NLL at the same theta: float32 sums in another order
VALUE_RTOL = 1e-5
#: the gradient at the same theta, against max|grad|
GRAD_RTOL = 1e-5
#: the start value of each of the first steps
START_RTOL = 1e-4
FINAL_RTOL = 1e-3
ACC_GAP = 0.005


def _accuracy(pred, gold):
    n = c = 0
    for p, g in zip(pred, gold):
        for a, b in zip(p, g):
            n += 1
            c += a == b
    return c / n


def _split(sentences):
    return ([[w for w, _ in s] for s in sentences],
            [[t for _, t in s] for s in sentences])


def _jax_fit(sentences, **kwargs):
    """JAX's tagger trained on ``sentences``, its ``nll`` and the value
    at the start of each L-BFGS step (read from inside its jitted update
    through ``optax.value_and_grad_from_state``)."""
    captured, values = {}, []
    orig = optax.value_and_grad_from_state

    def recording(fn):
        captured["nll"] = fn
        value_and_grad = orig(fn)

        def wrapped(params, *, state):
            v, g = value_and_grad(params, state=state)
            jax.debug.callback(lambda x: values.append(float(x)), v)
            return v, g

        return wrapped

    optax.value_and_grad_from_state = recording
    try:
        with use_mesh(make_mesh(jax.devices()[:1])):
            tagger = jcrf.LinearChainCRFTagger(**kwargs).train(sentences)
    finally:
        optax.value_and_grad_from_state = orig
    return tagger, captured["nll"], values


def _jax_theta(tagger):
    return np.concatenate([np.asarray(tagger.emit).ravel(),
                           np.asarray(tagger.trans).ravel(),
                           np.asarray(tagger.start)])


@pytest.fixture(scope="module")
def pos_data():
    corpus = generate_pos_corpus(N_TRAIN + 100, seed=0)
    return corpus[:N_TRAIN], corpus[N_TRAIN:]


@pytest.fixture(scope="module")
def jax_pos(pos_data):
    train, _ = pos_data
    return _jax_fit(train, n_buckets=BUCKETS, max_iter=MAX_ITER)


@pytest.fixture(scope="module")
def port_pos(pos_data):
    train, _ = pos_data
    return LinearChainCRFTagger(n_buckets=BUCKETS, max_iter=MAX_ITER,
                                device="cpu").train(train)


# ------------------------------------------------------------ host features


@pytest.mark.parametrize("n_buckets", [1 << 12, 1 << 15])
def test_hashed_ids_and_padding_equal_jax(n_buckets):
    sentences = generate_ner_corpus(40, seed=3) + generate_pos_corpus(40, 5)
    tokens = [[w for w, _ in s] for s in sentences] + [["Émile", "x/y", ""]]
    ids = [crf._hash_features(t, n_buckets) for t in tokens]
    want = [jcrf._hash_features(t, n_buckets) for t in tokens]
    for got, exp in zip(ids, want):
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    for pad in (8, 16):
        got, exp = crf._pad_batch(ids, pad), jcrf._pad_batch(want, pad)
        assert all(np.array_equal(a, b) for a, b in zip(got, exp))


# --------------------------------------------------------------- objective


def test_nll_and_gradient_equal_jax_at_the_same_theta(pos_data, jax_pos):
    train, _ = pos_data
    _, nll, _ = jax_pos
    port = LinearChainCRFTagger(n_buckets=BUCKETS, device="cpu")
    objective = port.objective(train)
    theta = (0.1 * np.random.default_rng(0).standard_normal(
        objective.size)).astype(np.float32)
    want_v, want_g = jax.jit(jax.value_and_grad(nll))(jnp.asarray(theta))
    got_v, got_g = objective(torch.from_numpy(theta))
    want_v, want_g = float(want_v), np.asarray(want_g)
    assert abs(float(got_v) - want_v) <= VALUE_RTOL * abs(want_v)
    err = np.abs(got_g.numpy() - want_g).max()
    assert err <= GRAD_RTOL * np.abs(want_g).max(), err


def test_nll_with_one_token_sentences_and_padding():
    """Sentences of one token (no transition) among longer ones: the
    padded gold entries are read and masked, as JAX's are."""
    sentences = [[("Smith", "B-PER")], [("the", "O"), ("Acme", "B-ORG"),
                                        ("Corp", "I-ORG")], [("in", "O")]]
    captured = {}
    orig = optax.value_and_grad_from_state

    class Captured(Exception):
        pass

    def recording(fn):  # JAX's nll, taken before its fit compiles
        captured["nll"] = fn
        raise Captured

    optax.value_and_grad_from_state = recording
    try:
        with use_mesh(make_mesh(jax.devices()[:1])):
            with pytest.raises(Captured):
                jcrf.LinearChainCRFTagger(n_buckets=64).train(sentences)
    finally:
        optax.value_and_grad_from_state = orig
    objective = LinearChainCRFTagger(n_buckets=64, device="cpu").objective(
        sentences)
    theta = np.random.default_rng(1).standard_normal(
        objective.size).astype(np.float32)
    want = float(captured["nll"](jnp.asarray(theta)))
    got = float(objective(torch.from_numpy(theta))[0])
    assert abs(got - want) <= VALUE_RTOL * abs(want)


# ------------------------------------------------------------------- fit


def test_small_fit_follows_jax_step_by_step(pos_data, jax_pos, port_pos):
    train, test = pos_data
    jtagger, nll, jvalues = jax_pos
    assert port_pos.tags == jtagger.tags
    got = np.asarray(port_pos.loss_history)
    want = np.asarray(jvalues)
    assert np.all(np.abs(got[:5] - want[:5]) <= START_RTOL * np.abs(want[:5]))
    # no early stop in 20 steps, in either package
    assert len(got) == len(want) == MAX_ITER
    final_port = float(port_pos.objective(train)(port_pos.theta)[0])
    final_jax = float(nll(jnp.asarray(_jax_theta(jtagger))))
    assert abs(final_port - final_jax) <= FINAL_RTOL * abs(final_jax)
    tokens, gold = _split(test)
    acc_port = _accuracy(port_pos.predict_batch(tokens), gold)
    acc_jax = _accuracy(jtagger.predict_batch(tokens), gold)
    assert abs(acc_port - acc_jax) <= ACC_GAP, (acc_port, acc_jax)


def test_early_stop_step_equals_jax():
    """A fit that converges before ``max_iter``: both stop by JAX's rule,
    within one step of each other. The rule compares successive start
    values at 1e-7 relative, under float32's resolution (6e-8) of two
    packages summing in different orders, so the last step may land
    either side of it: at this size JAX stops after 35 steps and the
    port after 34; at `chip_smoke.py`'s NER size both after 34."""
    train = generate_ner_corpus(200, seed=2)
    jtagger, _, jvalues = _jax_fit(train, n_buckets=1 << 10, max_iter=80)
    port = LinearChainCRFTagger(n_buckets=1 << 10, max_iter=80,
                                device="cpu").train(train)
    assert len(jvalues) < 80
    assert abs(len(port.loss_history) - len(jvalues)) <= 1
    assert jax_stop(port.loss_history)
    assert not jax_stop(port.loss_history[:-1])
    n = min(len(port.loss_history), len(jvalues))
    assert port.loss_history[n - 1] == pytest.approx(jvalues[n - 1],
                                                     rel=FINAL_RTOL)


def test_jax_stop_rule():
    flat = [5.0] * 11
    assert not jax_stop(flat)          # it = 10: never before step 11
    assert jax_stop(flat + [5.0])
    assert not jax_stop(flat + [5.0 - 1e-6])
    assert jax_stop(flat + [5.0 - 1e-7])  # 1e-7 < 1e-7·5


def test_lbfgs_stop_default_leaves_callers_unchanged():
    """``stop`` off (the default, or a predicate that never holds) runs
    every step, with the same iterates; the ridge fit is unchanged."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((64, 12)).astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    objective = _Objective(X, Y, 0.1)
    W0 = torch.zeros(12, 3)
    a = lbfgs_minimize(objective, W0, 15)
    b = lbfgs_minimize(objective, W0, 15, stop=None)
    c = lbfgs_minimize(objective, W0, 15, stop=lambda history: False)
    for other in (b, c):
        assert torch.equal(a[0], other[0])
        assert a[1] == other[1] and a[2] == other[2]
    assert len(a[1]) == 15
    d = lbfgs_minimize(objective, W0, 15, stop=lambda history: len(history) == 4)
    assert d[1] == a[1][:4]
    from keystone_tpu_torch.data.dataset import Dataset

    est = DenseLBFGSwithL2(lam=0.1, num_iters=15)
    est.fit(Dataset(X, device="cpu"), Dataset(Y, device="cpu"))
    Xc, Yc = X - X.sum(0) / 64, Y - Y.sum(0) / 64
    want = lbfgs_minimize(_Objective(Xc, Yc, 0.1), W0, 15)
    assert est.loss_history.tolist() == pytest.approx(want[1], rel=1e-6)
    assert est.linesearch_steps == want[2]


# ------------------------------------------------------------------ decode


def test_viterbi_equals_jax_on_carried_weights(pos_data, jax_pos):
    _, test = pos_data
    jtagger, _, _ = jax_pos
    port = crf_tagger_from_jax(jtagger.tags, jtagger.emit, jtagger.trans,
                               jtagger.start, jtagger.n_buckets,
                               device="cpu")
    tokens, _ = _split(test)
    # lengths in the buckets 8, 16, 32 and 64, and empty lists
    long = [sum(tokens[i:i + 4], []) for i in range(0, 40, 4)]
    for batch in (tokens, tokens[:3], long, [[], tokens[0], []],
                  [["the"]], [[]]):
        assert port.predict_batch(batch) == jtagger.predict_batch(batch)
    assert {port._bucket(len(t)) for t in tokens + long} >= {16, 32, 64}


def test_empty_and_single(port_pos):
    assert port_pos.predict([]) == []
    out = port_pos.predict(["the"])
    assert len(out) == 1 and out[0] in port_pos.tags


def test_crf_ner_bio():
    corpus = generate_ner_corpus(500, seed=1)
    train, test = corpus[:400], corpus[400:]
    tagger = LinearChainCRFTagger(n_buckets=1 << 12, max_iter=30,
                                  device="cpu").train(train)
    tokens, gold = _split(test)
    preds = tagger.predict_batch(tokens)
    assert _accuracy(preds, gold) > 0.97
    for pred in preds:
        prev = "O"
        for t in pred:
            if t.startswith("I-"):
                assert prev in (t, "B-" + t[2:]), (prev, t, pred)
            prev = t


def test_crf_matches_structured_perceptron(pos_data, port_pos):
    """Same data, same held-out split: the CRF does at least as well as
    the structured perceptron, less 0.005 (`tests/test_crf_tagger.py`)."""
    train, test = pos_data
    tokens, gold = _split(test)
    perc = StructuredPerceptronTagger().train(train, n_iter=3)
    perc_acc = _accuracy([perc(t) for t in tokens], gold)
    crf_acc = _accuracy(port_pos.predict_batch(tokens), gold)
    assert crf_acc >= perc_acc - 0.005, (crf_acc, perc_acc)


# ------------------------------------------------------------- persistence


def test_npz_files_cross_between_packages(tmp_path, pos_data, jax_pos,
                                          port_pos):
    _, test = pos_data
    tokens, _ = _split(test[:20])
    jtagger, _, _ = jax_pos
    # JAX → port
    path = str(tmp_path / "jax.npz")
    jtagger.save(path)
    loaded = LinearChainCRFTagger.load(path, device="cpu")
    assert loaded.tags == jtagger.tags and loaded.n_buckets == BUCKETS
    assert np.array_equal(loaded.emit.numpy(), jtagger.emit)
    assert loaded.predict_batch(tokens) == jtagger.predict_batch(tokens)
    # port → JAX
    path = str(tmp_path / "port.npz")
    port_pos.save(path)
    with use_mesh(make_mesh(jax.devices()[:1])):
        back = jcrf.LinearChainCRFTagger.load(path)
        assert back.tags == port_pos.tags
        assert np.array_equal(back.emit, port_pos.emit.numpy())
        assert back.predict_batch(tokens) == port_pos.predict_batch(tokens)
    keys = sorted(np.load(path).files)
    assert keys == ["emit", "n_buckets", "start", "tags", "trans"]
    again = LinearChainCRFTagger.load(path, device="cpu")
    assert again("the company reported a strong profit .".split()) == \
        port_pos("the company reported a strong profit .".split())


def test_postagger_crf_hook():
    from keystone_tpu_torch.nodes.nlp import POSTagger
    from keystone_tpu_torch.nodes.nlp.annotators import crf_tagger

    model = crf_tagger("pos", n_sentences=300, max_iter=25, device="cpu")
    assert crf_tagger("pos", n_sentences=300, max_iter=25,
                      device="cpu") is model
    pairs = POSTagger(model=model).apply(
        ["the", "manager", "approved", "the", "plan", "."])
    tags = [t for _, t in pairs]
    assert tags[0] == "DT" and tags[1] == "NN"


def test_the_crf_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearChainCRFTagger()
    from keystone_tpu_torch.nodes.nlp import NER, POSTagger

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        POSTagger.trained_crf()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NER.trained_crf()
