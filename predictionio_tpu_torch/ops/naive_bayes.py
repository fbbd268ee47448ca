"""Multinomial Naive Bayes on the card (port of
``predictionio_tpu/ops/naive_bayes.py``; MLlib's
``NaiveBayes.train(lambda)`` as the classification template calls it,
NaiveBayesAlgorithm.scala:28-45).

The model is MLlib's multinomial NB:
``pi_c = log((N_c + lambda) / (N + C lambda))`` and
``theta_cj = log((F_cj + lambda) / (sum_j F_cj + D lambda))``, where
``F_cj`` sums feature j over class c. Training is a one-hot and one
``(C, n) @ (n, D)`` product in fp32 (TF32 off, :mod:`..device`) and the
two smoothed logs; prediction is one ``(b, D) @ (D, C)`` product and an
argmax. The JAX package computes these as plain XLA, with no Pallas
kernel, so they stay torch ops here.

Parity class: tolerance for ``pi``, ``theta`` and the probabilities
(the products sum in another order); labels are exact wherever the top
two log-joints differ by more than that tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch import device as device_mod


@dataclass
class NaiveBayesModel:
    """Log priors and log likelihoods: torch tensors on the train device
    after :func:`train`, numpy after a blob load (the same fields as the
    JAX package's model, so its blobs load field for field)."""
    pi: "torch.Tensor | np.ndarray"      # (C,) log class priors
    theta: "torch.Tensor | np.ndarray"   # (C, D) log feature likelihoods
    n_classes: int


def _on(x, dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def train(features, labels, lambda_: float = 1.0,
          n_classes: Optional[int] = None,
          device: device_mod.DeviceLike = None) -> NaiveBayesModel:
    """features (n, D) non-negative counts; labels (n,) int in [0, C).
    Runs on ``device`` (the card unless the caller asks for the CPU)."""
    dev = device_mod.resolve(device)
    x = _on(features, torch.float32, dev)
    y = _on(labels, torch.int64, dev)
    if n_classes is None:
        n_classes = int(y.max()) + 1
    d = x.shape[1]
    lam = torch.tensor(lambda_, dtype=torch.float32, device=dev)
    onehot = F.one_hot(y, n_classes).to(torch.float32)      # (n, C)
    class_counts = onehot.sum(dim=0)                         # (C,)
    feat_sums = onehot.T @ x                                 # (C, D)
    pi = torch.log(class_counts + lam) - torch.log(
        class_counts.sum() + n_classes * lam)
    theta = torch.log(feat_sums + lam) - torch.log(
        feat_sums.sum(dim=1, keepdim=True) + d * lam)
    return NaiveBayesModel(pi=pi, theta=theta, n_classes=n_classes)


def on_device(model: NaiveBayesModel,
              device: device_mod.DeviceLike = None) -> NaiveBayesModel:
    """The model with ``pi`` and ``theta`` as fp32 tensors on ``device``
    (resolved by the device policy)."""
    dev = device_mod.resolve(device)
    return NaiveBayesModel(pi=_on(model.pi, torch.float32, dev),
                           theta=_on(model.theta, torch.float32, dev),
                           n_classes=model.n_classes)


def log_joint(model_pi, model_theta, features) -> torch.Tensor:
    """(b, D) -> (b, C) unnormalized log p(c | x), on the device of
    ``model_pi`` (a tensor), or the device policy's for numpy models."""
    dev = (model_pi.device if isinstance(model_pi, torch.Tensor)
           else device_mod.resolve())
    pi = _on(model_pi, torch.float32, dev)
    theta = _on(model_theta, torch.float32, dev)
    x = torch.atleast_2d(_on(features, torch.float32, dev))
    return x @ theta.T + pi[None, :]


def predict(model: NaiveBayesModel, features) -> torch.Tensor:
    """(b,) class indices; the first maximum on ties, as ``jnp.argmax``."""
    return torch.argmax(log_joint(model.pi, model.theta, features), dim=1)


def predict_proba(model: NaiveBayesModel, features) -> torch.Tensor:
    """(b, C) class probabilities."""
    return torch.softmax(log_joint(model.pi, model.theta, features), dim=1)
