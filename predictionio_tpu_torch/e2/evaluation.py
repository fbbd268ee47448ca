"""k-fold cross-validation splitter (port of
``predictionio_tpu/e2/evaluation.py``; CrossValidation.scala:24-77,
CommonHelperFunctions.splitData): fold f's test set is every point with
index % k == f; training is the complement."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple


def split_data(
    eval_k: int,
    dataset: Sequence[Any],
    evaluator_info: Any,
    training_data_creator: Callable[[List[Any]], Any],
    query_creator: Callable[[Any], Any],
    actual_creator: Callable[[Any], Any],
) -> List[Tuple[Any, Any, List[Tuple[Any, Any]]]]:
    dataset = list(dataset)
    out = []
    for fold in range(eval_k):
        training = [p for i, p in enumerate(dataset) if i % eval_k != fold]
        testing = [p for i, p in enumerate(dataset) if i % eval_k == fold]
        out.append((
            training_data_creator(training),
            evaluator_info,
            [(query_creator(d), actual_creator(d)) for d in testing],
        ))
    return out
