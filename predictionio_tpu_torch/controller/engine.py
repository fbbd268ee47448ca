"""Engine: chains DASE classes; train and eval orchestration (port of
``predictionio_tpu/controller/engine.py``: EngineParams, engine.json
extraction, instantiation, ``Engine.train`` and ``Engine.eval``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

from predictionio_tpu_torch.controller.base import (
    Algorithm, DataSource, EmptyParams, Params, Preparator, SanityCheck,
    Serving, create_doer,
)

@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named parameter bundle for one engine variant; algorithm entries
    are (name, Params) pairs matching Engine.algorithm_class_map keys."""
    data_source_params: Params = dataclasses.field(default_factory=EmptyParams)
    preparator_params: Params = dataclasses.field(default_factory=EmptyParams)
    algorithm_params_list: Tuple[Tuple[str, Params], ...] = ()
    serving_params: Params = dataclasses.field(default_factory=EmptyParams)


def _params_from_json(params_cls: Optional[Type], obj: Dict[str, Any]) -> Params:
    """JSON object -> typed Params (unknown keys rejected)."""
    if params_cls is None:
        if obj:
            raise ValueError(
                f"component takes no params but engine.json provides {obj}")
        return EmptyParams()
    aliases = getattr(params_cls, "JSON_ALIASES", {})
    if aliases:
        obj = {aliases.get(k, k): v for k, v in obj.items()}
    fields = {f.name for f in dataclasses.fields(params_cls)}
    unknown = set(obj) - fields
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)} for {params_cls.__name__}"
            f" (accepts {sorted(fields)})")
    try:
        return params_cls(**obj)
    except TypeError as e:
        raise ValueError(
            f"invalid params for {params_cls.__name__}: {e}") from None


def _component_params(cls: Type, section) -> Params:
    return _params_from_json(getattr(cls, "params_class", None),
                             (section or {}).get("params", {}))


class Engine:
    """An engine = DataSource + Preparator + Algorithm(s) + Serving."""

    def __init__(self, data_source_class: Type[DataSource],
                 preparator_class: Type[Preparator],
                 algorithm_class_map: Dict[str, Type[Algorithm]],
                 serving_class: Type[Serving]):
        self.data_source_class = data_source_class
        self.preparator_class = preparator_class
        self.algorithm_class_map = dict(algorithm_class_map)
        self.serving_class = serving_class

    def _instantiate(self, engine_params: EngineParams):
        data_source = create_doer(self.data_source_class,
                                  engine_params.data_source_params)
        preparator = create_doer(self.preparator_class,
                                 engine_params.preparator_params)
        algorithms = []
        for name, aparams in engine_params.algorithm_params_list:
            if name not in self.algorithm_class_map:
                raise KeyError(
                    f"Unknown algorithm name {name!r}; engine defines "
                    f"{sorted(self.algorithm_class_map)}")
            algorithms.append(create_doer(self.algorithm_class_map[name],
                                          aparams))
        serving = create_doer(self.serving_class, engine_params.serving_params)
        return data_source, preparator, algorithms, serving

    def train(self, ctx, engine_params: EngineParams) -> List[Any]:
        """Read, prepare and train every algorithm (Engine.scala:625-712),
        each step a phase of ``ctx`` and sanity-checked."""
        data_source, preparator, algorithms, _ = self._instantiate(
            engine_params)
        if not algorithms:
            raise ValueError("engine_params.algorithm_params_list is empty")
        with ctx.phase("read"):
            td = data_source.read_training(ctx)
        self._sanity_check(td)
        with ctx.phase("prepare"):
            pd = preparator.prepare(ctx, td)
        self._sanity_check(pd)
        with ctx.phase("train"):
            models = [a.train(ctx, pd) for a in algorithms]
        for m in models:
            self._sanity_check(m)
        return models

    def make_serializable_models(self, ctx, instance_id: str,
                                 engine_params: EngineParams,
                                 models: List[Any]) -> List[Any]:
        """Each algorithm's persistence hook over its trained model
        (Engine.makeSerializableModels, Engine.scala:286-304); the
        algorithms are built afresh from their Params."""
        _, _, algorithms, _ = self._instantiate(engine_params)
        return [a.make_persistent_model(ctx, instance_id, m)
                for a, m in zip(algorithms, models)]

    @staticmethod
    def _sanity_check(obj) -> None:
        if isinstance(obj, SanityCheck):
            obj.sanity_check()

    def eval(self, ctx, engine_params: EngineParams
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """[(EI, [(Q, P, A)])], one entry per fold, with no memoization
        (Engine.scala:730-820; ``workflow/fast_eval.py`` is the memoized
        path). Per fold: prepare, train every algorithm, batch-predict
        every algorithm over the supplemented queries, and combine each
        query's predictions with ``serving.serve``, which is fed the
        ORIGINAL query (Engine.scala:805)."""
        data_source, preparator, algorithms, serving = (
            self._instantiate(engine_params))
        eval_sets = data_source.read_eval(ctx)
        out = []
        for a in algorithms:
            a.bind_serving(ctx)
        for td, ei, qa_list in eval_sets:
            self._sanity_check(td)
            pd = preparator.prepare(ctx, td)
            self._sanity_check(pd)
            models = [a.train(ctx, pd) for a in algorithms]
            indexed_q = [(qx, serving.supplement(q))
                         for qx, (q, _a) in enumerate(qa_list)]
            per_algo = [dict(algo.batch_predict(model, indexed_q))
                        for algo, model in zip(algorithms, models)]
            qpa = [(q, serving.serve(q, [pred[qx] for pred in per_algo]), a)
                   for qx, (q, a) in enumerate(qa_list)]
            out.append((ei, qpa))
        return out

    def engine_params_from_json(self, variant_json: Dict[str, Any]
                                ) -> EngineParams:
        algo_list = []
        if "algorithms" not in variant_json and "" in self.algorithm_class_map:
            algo_list.append(("", _params_from_json(
                getattr(self.algorithm_class_map[""], "params_class", None),
                {})))
        for entry in variant_json.get("algorithms", []):
            name = entry.get("name")
            if name is None:
                raise ValueError("each algorithms[] entry needs a \"name\"")
            if name not in self.algorithm_class_map:
                raise KeyError(
                    f"engine.json algorithm {name!r} not registered; engine "
                    f"defines {sorted(self.algorithm_class_map)}")
            algo_cls = self.algorithm_class_map[name]
            algo_list.append((name, _params_from_json(
                getattr(algo_cls, "params_class", None),
                entry.get("params", {}))))
        return EngineParams(
            data_source_params=_component_params(
                self.data_source_class, variant_json.get("datasource")),
            preparator_params=_component_params(
                self.preparator_class, variant_json.get("preparator")),
            algorithm_params_list=tuple(algo_list),
            serving_params=_params_from_json(
                getattr(self.serving_class, "params_class", None),
                (variant_json.get("serving") or {}).get("params", {})),
        )


class SimpleEngine(Engine):
    """One-algorithm sugar (EngineParams.scala:130-160): the algorithm is
    registered under the name ``""``."""

    def __init__(self, data_source_class, preparator_class, algorithm_class,
                 serving_class):
        super().__init__(data_source_class, preparator_class,
                         {"": algorithm_class}, serving_class)
