"""HelloWorld: per-day average temperature (port of
``predictionio_tpu/examples/helloworld.py``).

Parity: examples/experimental/scala-local-helloworld/HelloWorld.scala (and
the java-local / java-parallel variants — one Python runtime here). A CSV of
``day,temperature`` lines trains a day → mean-temperature model; querying a
day returns its average. The fold is a segment mean on the context's
device (the card unless the caller asks for the CPU), so even the toy
engine exercises the device path end to end: the temperatures sorted by
day and summed by ``torch.segment_reduce`` in a fixed order (no float
atomics, so the means do not depend on launch order), the counts an
exact host bincount.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    DataSource, FirstServing, IdentityPreparator, Params, SimpleEngine,
)
from predictionio_tpu_torch.controller.base import Algorithm


@dataclass(frozen=True)
class HelloWorldDataSourceParams(Params):
    filepath: str


@dataclass
class HelloWorldTrainingData:
    temperatures: List[Tuple[str, float]]     # (day, temperature)


@dataclass(frozen=True)
class HelloQuery:
    day: str


@dataclass
class HelloPrediction:
    temperature: float


class HelloWorldDataSource(DataSource):
    params_class = HelloWorldDataSourceParams

    def __init__(self, params: HelloWorldDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> HelloWorldTrainingData:
        rows: List[Tuple[str, float]] = []
        with open(self.dsp.filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                day, temp = line.split(",")
                rows.append((day, float(temp)))
        return HelloWorldTrainingData(rows)


class HelloWorldAlgorithm(Algorithm):
    """Day-keyed mean via a segment sum (HelloWorld.scala:MyAlgorithm)."""

    def train(self, ctx, pd: HelloWorldTrainingData) -> Dict[str, float]:
        dev = device_mod.resolve(getattr(ctx, "device", None))
        days = sorted({d for d, _ in pd.temperatures})
        code = {d: i for i, d in enumerate(days)}
        seg = np.asarray([code[d] for d, _ in pd.temperatures],
                         dtype=np.int64)
        temps = np.asarray([t for _, t in pd.temperatures],
                           dtype=np.float32)
        # every day has a reading, so no segment is empty
        counts = np.bincount(seg, minlength=len(days))
        order = np.argsort(seg, kind="stable")
        totals = torch.segment_reduce(
            torch.as_tensor(temps[order], device=dev), "sum",
            lengths=torch.as_tensor(counts, device=dev), unsafe=True)
        means = (totals / torch.as_tensor(counts, dtype=torch.float32,
                                          device=dev)).cpu().numpy()
        return {d: float(means[i]) for d, i in code.items()}

    def predict(self, model: Dict[str, float],
                query: HelloQuery) -> HelloPrediction:
        return HelloPrediction(temperature=model[query.day])

    @property
    def query_class(self):
        return HelloQuery


def engine() -> SimpleEngine:
    """MyEngineFactory (HelloWorld.scala)."""
    return SimpleEngine(HelloWorldDataSource, IdentityPreparator,
                        HelloWorldAlgorithm, FirstServing)
