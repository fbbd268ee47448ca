"""Reusable algorithm library (port of ``predictionio_tpu/e2``; ref:
e2/src/main/scala/.../e2/): categorical Naive Bayes, the Markov chain,
the binary vectorizer and the k-fold splitter."""

from predictionio_tpu_torch.e2.engine import (
    BinaryVectorizer, CategoricalNaiveBayes, CategoricalNaiveBayesModel,
    LabeledPoint, MarkovChain, MarkovChainModel,
)
from predictionio_tpu_torch.e2.evaluation import split_data

__all__ = [
    "BinaryVectorizer", "CategoricalNaiveBayes", "CategoricalNaiveBayesModel",
    "LabeledPoint", "MarkovChain", "MarkovChainModel", "split_data",
]
