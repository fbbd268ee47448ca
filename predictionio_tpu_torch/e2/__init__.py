"""Reusable algorithm library (port of ``predictionio_tpu/e2``): the
k-fold splitter. CategoricalNaiveBayes, MarkovChain and BinaryVectorizer
(``e2/engine.py``) are not ported yet."""

from predictionio_tpu_torch.e2.evaluation import split_data

__all__ = ["split_data"]
