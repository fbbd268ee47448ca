"""FakeRun: run an arbitrary function under the full workflow environment
(port of ``predictionio_tpu/workflow/fake.py``).

Parity: core/.../workflow/FakeWorkflow.scala:28-109 (@Experimental). The
reference lets engine developers execute `(SparkContext => Unit)` through
`pio eval`, getting the exact runtime (context, storage, logging) a real
evaluation would see. Here the function receives the WorkflowContext:

    # myexp.py
    from predictionio_tpu_torch.workflow.fake import FakeRun

    class HelloWorld(FakeRun):
        def func(self, ctx):
            print("storage:", ctx.storage)

    # $ python -m predictionio_tpu_torch.tools.cli eval myexp:HelloWorld

Results are not persisted (FakeEvalResult.noSave parity) beyond the
EVALCOMPLETED ledger row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

from predictionio_tpu_torch.controller import (
    EngineParams, Params,
)
from predictionio_tpu_torch.controller.evaluation import Evaluation
from predictionio_tpu_torch.controller.base import (
    DataSource, Preparator, Serving,
)
from predictionio_tpu_torch.controller.engine import Engine


@dataclass(frozen=True)
class _NoParams(Params):
    pass


class _EmptyDataSource(DataSource):
    params_class = _NoParams

    def __init__(self, params):
        pass

    def read_training(self, ctx):
        return None

    def read_eval(self, ctx) -> List[Tuple[Any, Any, List[Tuple[Any, Any]]]]:
        return []   # no folds: the evaluator below never looks at data


class _IdPreparator(Preparator):
    params_class = _NoParams

    def __init__(self, params):
        pass

    def prepare(self, ctx, td):
        return td


class _FirstServing(Serving):
    params_class = _NoParams

    def __init__(self, params):
        pass

    def serve(self, query, predictions):
        return predictions[0] if predictions else None


class FakeEngine(Engine):
    """Engine shell whose eval produces no folds (FakeEngine parity)."""

    def __init__(self):
        super().__init__(
            data_source_class=_EmptyDataSource,
            preparator_class=_IdPreparator,
            algorithm_class_map={},
            serving_class=_FirstServing)


class FakeEvalResult:
    """noSave result (FakeWorkflow.scala:69-72)."""
    no_save = True

    def __str__(self) -> str:
        return "FakeEvalResult()"

    def to_html(self) -> str:
        return ""

    def to_json(self) -> str:
        return "{}"


class _FakeEvaluator:
    output_path = None

    def __init__(self, run):
        self._run = run

    def evaluate_base(self, ctx, evaluation, engine_eval_data_sets):
        self._run.func(ctx)
        return FakeEvalResult()


class FakeRun(Evaluation):
    """Subclass, override func(self, ctx), run with `pio eval mod:Class`."""

    def __init__(self):
        self.engine = FakeEngine()
        self.engine_params_list = [EngineParams()]
        super().__init__()

    @property
    def evaluator(self):
        return _FakeEvaluator(self)

    def func(self, ctx) -> None:   # override me
        raise NotImplementedError("override FakeRun.func(self, ctx)")
