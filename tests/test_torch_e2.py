"""e2's components in the port against the JAX package, on the CPU:
the JAX package's ``tests/test_e2.py`` cases, then seeded inputs through
both packages.

Parity classes:
- **exact**: Naive Bayes priors and likelihoods (host floats from exact
  counts), predictions and log scores, ``BinaryVectorizer``, and the
  Markov chain's kept-entry mask (the threshold ``sort(t)[:, -N]`` keeps
  every entry that ties the N-th largest of its row);
- **tolerance**: the Markov chain's probabilities and its ``predict``
  (fp32 row totals and a matvec summed in another order: rtol 1e-6,
  atol 1e-7).
"""

import math

import numpy as np
import pytest
import torch

from predictionio_tpu import e2 as je2
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch import e2
from predictionio_tpu_torch.workflow import model_io

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")


def _points(pkg):
    return [pkg.LabeledPoint(l, f) for l, f in (
        ("yes", ("sunny", "hot")), ("yes", ("sunny", "mild")),
        ("yes", ("overcast", "mild")), ("no", ("rain", "mild")),
        ("no", ("rain", "hot")))]


def _random_points(pkg, seed=3, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = f"L{rng.integers(4)}"
        out.append(pkg.LabeledPoint(label, tuple(
            f"v{rng.integers(1 + 2 * k)}" for k in range(4))))
    return out


def test_categorical_nb_priors_and_likelihoods():
    model = e2.CategoricalNaiveBayes.train(_points(e2))
    assert model.priors["yes"] == pytest.approx(math.log(3 / 5))
    assert model.likelihoods["yes"][0]["sunny"] == pytest.approx(
        math.log(2 / 3))
    assert "sunny" not in model.likelihoods["no"][0]
    assert model.feature_count == 2
    for pts in ((_points(e2), _points(je2)),
                (_random_points(e2), _random_points(je2))):
        m, jm = (p.CategoricalNaiveBayes.train(x)
                 for p, x in zip((e2, je2), pts))
        assert m.priors == jm.priors
        assert m.likelihoods == jm.likelihoods


def test_categorical_nb_predict_and_log_score():
    pts, jpts = _random_points(e2, seed=5), _random_points(je2, seed=5)
    m = e2.CategoricalNaiveBayes.train(pts)
    jm = je2.CategoricalNaiveBayes.train(jpts)
    base = e2.CategoricalNaiveBayes.train(_points(e2))
    assert base.predict(("sunny", "hot")) == "yes"
    assert base.log_score(e2.LabeledPoint("maybe", ("sunny", "hot"))) is None
    assert base.log_score(e2.LabeledPoint("no", ("sunny", "hot"))) == \
        float("-inf")
    floor = lambda ls: min(ls) - 1.0          # noqa: E731
    for p, jp in zip(pts[:60], jpts[:60]):
        assert m.predict(p.features) == jm.predict(jp.features)
        for label in ("L0", "L3", "nope"):
            assert m.log_score(e2.LabeledPoint(label, p.features)) == \
                jm.log_score(je2.LabeledPoint(label, jp.features))
            assert m.log_score(e2.LabeledPoint(label, p.features),
                               default_likelihood=floor) == \
                jm.log_score(je2.LabeledPoint(label, jp.features),
                             default_likelihood=floor)


def test_markov_chain_topn_and_predict():
    model = e2.MarkovChain.train(rows=[0, 0, 1], cols=[1, 2, 0],
                                 counts=[3.0, 1.0, 2.0], n_states=3,
                                 top_n=1, device="cpu")
    assert isinstance(model.transition, torch.Tensor)
    t = model.transition.numpy()
    assert t[0, 1] == pytest.approx(0.75) and t[0, 2] == 0.0
    assert t[1, 0] == pytest.approx(1.0)
    nxt = model.predict([1.0, 0.0, 0.0])
    assert nxt[1] == pytest.approx(0.75) and nxt[0] == 0.0


def _tally(seed, n_states=40, n=2000):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_states, n)
    cols = rng.integers(0, n_states, n)
    # small integer counts: many ties at each row's N-th value
    counts = rng.integers(1, 4, n).astype(np.float64)
    return rows, cols, counts, n_states


@pytest.mark.parametrize("top_n", [1, 3, 10, 60])
def test_markov_chain_keeps_every_tie_as_the_reference(top_n):
    rows, cols, counts, s = _tally(7)
    # one more state, whose row's top-3 boundary is a tie of four entries
    rows = np.concatenate([rows, [s] * 6])
    cols = np.concatenate([cols, [0, 1, 2, 3, 4, 5]])
    counts = np.concatenate([counts, [50.0, 9.0, 9.0, 9.0, 9.0, 1.0]])
    s += 1
    m = e2.MarkovChain.train(rows, cols, counts, s, top_n, device="cpu")
    jm = je2.MarkovChain.train(rows, cols, counts, s, top_n)
    t, jt = m.transition.numpy(), np.asarray(jm.transition)
    assert ((t > 0) == (jt > 0)).all()                     # exact mask
    np.testing.assert_allclose(t, jt, rtol=RTOL, atol=ATOL)
    if top_n == 3:
        assert (t[s - 1] > 0).sum() == 5     # 50 and all four 9s kept
    state = np.random.default_rng(1).random(s)
    np.testing.assert_allclose(m.predict(state), jm.predict(state),
                               rtol=RTOL, atol=ATOL)


def test_markov_model_carried_from_the_reference():
    rows, cols, counts, s = _tally(11, n_states=12, n=200)
    jm = je2.MarkovChain.train(rows, cols, counts, s, 4)
    (carried,) = model_io.deserialize_models(
        jmodel_io.serialize_models([jm]))
    assert type(carried) is e2.MarkovChainModel
    built = model_io.markov_chain_model_from_numpy(
        np.asarray(jm.transition), jm.n, device="cpu")
    assert isinstance(built.transition, torch.Tensor)
    state = np.eye(s)[3]
    for model in (carried, built):
        assert model.predict(state) == jm.predict(state)   # one row: exact
        assert model.n == jm.n


def test_binary_vectorizer():
    maps = [{"color": "red", "size": "L", "junk": "x"},
            {"color": "blue", "size": "L"}, {"size": "S", "color": "red"}]
    out = []
    for pkg in (e2, je2):
        vec = pkg.BinaryVectorizer.from_maps(maps, properties=["color",
                                                               "size"])
        v = vec.to_binary([("color", "red"), ("size", "L")])
        assert v.sum() == 2.0 and v.dtype == np.float32
        assert vec.to_binary([("color", "green")]).sum() == 0.0
        batch = vec.to_binary_batch([[("color", "red")], [("size", "L")]])
        v2 = pkg.BinaryVectorizer.from_pairs([("a", "1"), ("b", "2")])
        out.append((str(vec), vec.property_map, v.tobytes(),
                    batch.tobytes(), batch.shape,
                    vec.to_binary_batch([]).shape,
                    v2.to_binary([("b", "2")]).tolist()))
    assert out[0] == out[1]


def test_split_data_folds():
    data = list(range(10))
    kw = dict(eval_k=3, dataset=data, evaluator_info="EI",
              training_data_creator=list,
              query_creator=lambda d: ("q", d),
              actual_creator=lambda d: ("a", d))
    assert e2.split_data(**kw) == je2.split_data(**kw)
