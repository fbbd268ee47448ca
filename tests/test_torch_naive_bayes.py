"""The port's multinomial Naive Bayes (``ops/naive_bayes.py``) and the
classification template's two algorithms, on the CPU, against the JAX
package on the same seeded numpy inputs.

Parity classes: ``pi`` and ``theta`` agree within rtol 1e-5 / atol
1e-6 (fp32 sums in another order). The log-joints sum D products of
magnitude up to ~100, so they agree to ~1e-5 absolute, and a class
probability, ``exp`` of a difference of them, to rtol 1e-4 / atol 1e-6;
labels are
exact wherever the two best log-joints of a row are more than 1e-4
apart, and on exact ties both take the first class. The random forest is
host numpy under one seeded generator in both packages: exact, tree for
tree."""

import numpy as np
import pytest
import torch

from predictionio_tpu.models.classification.data_source import (
    LabeledPoint as JLabeledPoint, TrainingData as JTrainingData,
)
from predictionio_tpu.models.classification.engine import Query as JQuery
from predictionio_tpu.models.classification.nb_algorithm import (
    NaiveBayesAlgorithm as JNaiveBayesAlgorithm,
    NaiveBayesAlgorithmParams as JNaiveBayesAlgorithmParams,
)
from predictionio_tpu.models.classification.random_forest import (
    RandomForestAlgorithm as JRandomForestAlgorithm,
    RandomForestAlgorithmParams as JRandomForestAlgorithmParams,
)
from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu_torch.models.classification.data_source import (
    LabeledPoint, TrainingData,
)
from predictionio_tpu_torch.models.classification.engine import Query
from predictionio_tpu_torch.models.classification.nb_algorithm import (
    NaiveBayesAlgorithm, NaiveBayesAlgorithmParams,
)
from predictionio_tpu_torch.models.classification.random_forest import (
    RandomForestAlgorithm, RandomForestAlgorithmParams,
)
from predictionio_tpu_torch.ops import naive_bayes as nb
from predictionio_tpu_torch.workflow.context import WorkflowContext

RTOL, ATOL, GAP = 1e-5, 1e-6, 1e-4
PROB_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")


def _data(seed, n, d, c):
    """Counts whose proportions depend on the class."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    rates = rng.uniform(0.2, 6.0, (c, d))
    x = rng.poisson(rates[y]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("seed,n,d,c,lam", [
    (0, 50, 3, 2, 1.0), (1, 1000, 3, 4, 1.0), (2, 300, 17, 5, 0.5),
    (3, 2000, 64, 10, 0.01),
])
def test_train_matches_the_reference(seed, n, d, c, lam):
    x, y = _data(seed, n, d, c)
    m = nb.train(x, y, lambda_=lam, n_classes=c, device="cpu")
    jm = jnb.train(x, y, lambda_=lam, n_classes=c)
    assert m.n_classes == jm.n_classes == c
    assert m.pi.dtype == m.theta.dtype == torch.float32
    np.testing.assert_allclose(m.pi.numpy(), np.asarray(jm.pi),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.theta.numpy(), np.asarray(jm.theta),
                               rtol=RTOL, atol=ATOL)
    # n_classes inferred from the labels, as the reference does
    assert nb.train(x, y, lambda_=lam, device="cpu").n_classes == \
        int(y.max()) + 1


@pytest.mark.parametrize("seed,d,c", [(4, 3, 4), (5, 12, 3)])
def test_probabilities_and_labels(seed, d, c):
    x, y = _data(seed, 800, d, c)
    m = nb.train(x, y, n_classes=c, device="cpu")
    jm = jnb.train(x, y, n_classes=c)
    xt, _ = _data(seed + 100, 500, d, c)
    np.testing.assert_allclose(nb.predict_proba(m, xt).numpy(),
                               np.asarray(jnb.predict_proba(jm, xt)),
                               rtol=PROB_RTOL, atol=ATOL)
    lj = np.asarray(jnb.log_joint(jm.pi, jm.theta, xt))
    np.testing.assert_allclose(nb.log_joint(m.pi, m.theta, xt).numpy(), lj,
                               rtol=RTOL, atol=1e-4)
    top2 = np.sort(lj, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert clear.mean() > 0.9
    got = nb.predict(m, xt).numpy()
    want = np.asarray(jnb.predict(jm, xt))
    np.testing.assert_array_equal(got[clear], want[clear])
    # a loaded model holds numpy: the same answers through the device
    # policy's device
    loaded = nb.NaiveBayesModel(pi=m.pi.numpy(), theta=m.theta.numpy(),
                                n_classes=c)
    np.testing.assert_array_equal(nb.predict(loaded, xt).numpy(), got)
    assert nb.on_device(loaded, "cpu").pi.device == torch.device("cpu")


def test_ties_take_the_first_class():
    # classes 1 and 2 see identical data: equal pi and theta rows
    x = np.array([[1, 0, 2], [3, 1, 1], [3, 1, 1], [0, 2, 1], [0, 2, 1]],
                 dtype=np.float32)
    y = np.array([0, 1, 2, 1, 2], dtype=np.int32)
    m = nb.train(x, y, device="cpu")
    jm = jnb.train(x, y)
    q = np.array([[3.0, 1.0, 1.0], [0.0, 5.0, 0.0]], dtype=np.float32)
    assert nb.predict(m, q).tolist() == np.asarray(
        jnb.predict(jm, q)).tolist() == [1, 1]
    assert nb.predict(m, np.array([3.0, 1.0, 1.0])).tolist() == [1]


def _points(x, y, labels, lp_cls, td_cls):
    return td_cls(labeled_points=[
        lp_cls(label=float(labels[int(c)]),
               features=tuple(float(v) for v in row))
        for row, c in zip(x, y)])


def test_naive_bayes_algorithm_matches_the_reference():
    labels = (3.0, 7.5, 11.0)            # plan ids, not class indices
    x, y = _data(6, 600, 3, 3)
    td = _points(x, y, labels, LabeledPoint, TrainingData)
    jtd = _points(x, y, labels, JLabeledPoint, JTrainingData)
    algo = NaiveBayesAlgorithm(NaiveBayesAlgorithmParams(lambda_=0.7))
    jalgo = JNaiveBayesAlgorithm(JNaiveBayesAlgorithmParams(lambda_=0.7))
    model = algo.train(WorkflowContext(device="cpu"), td)
    jmodel = jalgo.train(None, jtd)
    assert model.class_labels == jmodel.class_labels == labels
    np.testing.assert_allclose(model.nb.theta.numpy(),
                               np.asarray(jmodel.nb.theta), rtol=RTOL,
                               atol=ATOL)
    xt, _ = _data(7, 200, 3, 3)
    lj = np.asarray(jnb.log_joint(jmodel.nb.pi, jmodel.nb.theta, xt))
    top2 = np.sort(lj, axis=1)[:, -2:]
    queries = [(qx, Query(tuple(row))) for qx, row in enumerate(xt)]
    batch = dict(algo.batch_predict(model, queries))
    for qx, row in enumerate(xt):
        got = algo.predict(model, Query(tuple(row))).label
        assert batch[qx].label == got
        if top2[qx, 1] - top2[qx, 0] > GAP:
            assert got == jalgo.predict(jmodel, JQuery(tuple(row))).label
    assert algo.batch_predict(model, []) == []
    served = algo.prepare_serving(model)
    assert served.nb.theta.device == torch.device("cpu")
    assert algo.predict(served, Query(tuple(xt[0]))) == \
        algo.predict(model, Query(tuple(xt[0])))


@pytest.mark.parametrize("params", [
    dict(numClasses=2, numTrees=7, maxDepth=5, seed=9),
    dict(numClasses=3, numTrees=4, featureSubsetStrategy="all",
         impurity="entropy", maxDepth=3, maxBins=8, seed=1),
])
def test_random_forest_is_exact_at_equal_seeds(params):
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (240, 4))
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)
    if params["numClasses"] == 3:
        y = y + (x[:, 2] > 0.5)
    labels = (1.0, 3.0, 5.0)
    td = _points(x, y, labels, LabeledPoint, TrainingData)
    jtd = _points(x, y, labels, JLabeledPoint, JTrainingData)
    algo = RandomForestAlgorithm(RandomForestAlgorithmParams(**params))
    jalgo = JRandomForestAlgorithm(JRandomForestAlgorithmParams(**params))
    model, jmodel = algo.train(None, td), jalgo.train(None, jtd)
    assert model.class_labels == jmodel.class_labels
    assert len(model.trees) == len(jmodel.trees) == params["numTrees"]
    for t, jt in zip(model.trees, jmodel.trees):
        for f in ("feature", "threshold", "left", "right", "label"):
            a, b = getattr(t, f), getattr(jt, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    xt = rng.uniform(-1, 1, (60, 4))
    queries = [(qx, Query(tuple(row))) for qx, row in enumerate(xt)]
    jqueries = [(qx, JQuery(tuple(row))) for qx, row in enumerate(xt)]
    assert [p.label for _qx, p in algo.batch_predict(model, queries)] == \
        [p.label for _qx, p in jalgo.batch_predict(jmodel, jqueries)]
    assert algo.predict(model, queries[0][1]).label == \
        jalgo.predict(jmodel, jqueries[0][1]).label
