"""Training and evaluation run bookkeeping around the engine (port of
``run_train`` and ``run_evaluation`` in
``predictionio_tpu/workflow/core_workflow.py``).

A train run: snapshot the event store's head (the training cursor), insert
EngineInstance(INIT), ``engine.train``, serialize the models into the
Models store keyed by the instance id, mark COMPLETED with the phase
table, the read path (``train_stream``: on when the read streamed) and
the JSON-encoded cursor in ``runtime_conf``. A failure marks the row ERROR and
keeps its iteration snapshots, which the next run of the same
engine/variant resumes from (auto-resume). In a multi-process job
(``pio train --coordinator``) every rank runs the train (the sharded
trainer's collectives need all of them), but only rank 0 writes the
ledger row and the model blob; the others train and return "". A resume
is refused there, and iteration snapshots are off on every rank: each
rank would snapshot and restore on its own.

``WorkflowParams.profile_dir`` (``pio train --profile DIR``) wraps the
train in a ``common/profiling.trace`` capture, a Chrome trace of the
run's CPU operators and kernels, and writes the phase table beside it as
``telemetry_phases.json``.

An eval run: insert EvaluationInstance(INIT), evaluate every EngineParams
variant through the prefix-memoized FastEvalEngineWorkflow, score with
the evaluation's MetricEvaluator, store the results and mark
EVALCOMPLETED (ERROR on failure).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import traceback
from typing import Optional, Sequence

from predictionio_tpu_torch import knobs
from predictionio_tpu_torch.common import profiling
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.evaluation import (
    Evaluation, MetricEvaluatorResult,
)
from predictionio_tpu_torch.data.storage import (
    EngineInstance, EvaluationInstance, Model,
)
from predictionio_tpu_torch.parallel import mesh as mesh_mod
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.checkpoint import (
    FactorCheckpointer, latest_step_in, run_checkpoint_dir,
)
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.fast_eval import FastEvalEngineWorkflow

logger = logging.getLogger("predictionio_tpu_torch.workflow")


def _now():
    return _dt.datetime.now(_dt.timezone.utc)


def _find_auto_resume(instances, engine_id: str,
                      engine_variant: str) -> Optional[str]:
    """Newest crashed run (ERROR, or INIT after a hard kill) of this
    engine/variant whose iteration snapshots survived. Don't run two
    trains of one variant against one ledger at once: an INIT row could
    be a training still running elsewhere. ``PIO_AUTO_RESUME=0`` or
    ``train --no-auto-resume`` opts out."""
    best = None
    for row in instances.get_all():
        if (row.engine_id != engine_id
                or row.engine_variant != engine_variant
                or row.status not in ("ERROR", "INIT")):
            continue
        if latest_step_in(run_checkpoint_dir(row.id)) is None:
            continue
        if best is None or row.start_time > best.start_time:
            best = row
    return best.id if best else None


def _head_cursor(storage, engine_params: EngineParams):
    """The event-store head of the app ``datasourceparams.appName``
    names, taken before the training read: the batch base the model
    absorbs. Best effort: None for a store without cursors, an engine
    without an app name, or any failure. Events landing during the read
    are folded again by the speed layer (idempotent re-solves), never
    lost."""
    try:
        events = storage.get_events()
    except Exception:   # metadata-only storage
        return None
    if not hasattr(events, "head_cursor"):
        return None
    try:
        dsp = getattr(engine_params, "data_source_params", None)
        app_name = getattr(dsp, "appName", None)
        if not app_name:
            return None
        app = storage.get_meta_data_apps().get_by_name(str(app_name))
        return events.head_cursor(app.id, None) if app is not None else None
    except Exception:
        return None


def run_train(
    ctx: WorkflowContext,
    engine: Engine,
    engine_params: EngineParams,
    engine_id: str = "default",
    engine_version: str = "NOT_USED",
    engine_variant: str = "default",
    engine_factory: str = "",
    params_json: Optional[dict] = None,
    resume_from: Optional[str] = None,
) -> str:
    """Run one training; returns the COMPLETED EngineInstance id
    (CoreWorkflow.runTrain, CoreWorkflow.scala:45-101). ``resume_from``
    names a failed run whose iteration snapshots seed this one."""
    knobs.refuse_unported(knobs.TRAIN)
    multiprocess = mesh_mod.is_multiprocess()
    if multiprocess:
        if resume_from:
            raise ValueError(
                "resume_from is not supported on multi-process jobs: "
                "iteration snapshots are per process, so ranks would "
                "restore divergent factors. Re-run the training from "
                "scratch.")
        ctx.checkpoint_dir = None   # one segment on every rank
        if mesh_mod.process_index() != 0:
            engine.train(ctx, engine_params)
            return ""
    instances = ctx.storage.get_meta_data_engine_instances()
    # the training cursor (runtime_conf["train_cursor"]): autotrain's
    # volume trigger and the fold-in rebase after a reload key off it
    train_cursor = _head_cursor(ctx.storage, engine_params)
    ctx.train_stream = False
    if resume_from is None and not multiprocess and os.environ.get(
            "PIO_AUTO_RESUME", "1") != "0":
        auto = _find_auto_resume(instances, engine_id, engine_variant)
        if auto:
            logger.info(
                "Auto-resuming from crashed run %s's iteration snapshots "
                "(disable with --no-auto-resume / PIO_AUTO_RESUME=0)", auto)
            resume_from = auto
    pj = params_json or {}
    instance_id = instances.insert(EngineInstance(
        id="", status="INIT", start_time=_now(), end_time=_now(),
        engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant, engine_factory=engine_factory,
        batch=ctx.workflow_params.batch,
        data_source_params=json.dumps(pj.get("datasource", {})),
        preparator_params=json.dumps(pj.get("preparator", {})),
        algorithms_params=json.dumps(pj.get("algorithms", [])),
        serving_params=json.dumps(pj.get("serving", {})),
    ))
    logger.info("EngineInstance %s created (INIT)", instance_id)
    # a resumed run reuses the crashed run's directory, so its snapshots
    # are the ones consulted
    ctx.checkpoint_dir = (None if multiprocess
                          else run_checkpoint_dir(resume_from or instance_id))
    try:
        profile_dir = ctx.workflow_params.profile_dir
        if profile_dir:
            with profiling.trace(profile_dir, label="train"):
                models = engine.train(ctx, engine_params)
        else:
            models = engine.train(ctx, engine_params)
        with ctx.phase("persist"):
            # a PersistentModel saves itself here and its manifest rides
            # the blob in its place
            models = engine.make_serializable_models(
                ctx, instance_id, engine_params, models)
            blob = model_io.serialize_models(
                models,
                check_finite=os.environ.get("PIO_FINITE_CHECK", "1") != "0")
            ctx.storage.get_model_data_models().insert(
                Model(id=instance_id, models=blob))
        phases = dict(ctx.phase_seconds)
        if profile_dir:
            # the host-side phase split lands next to the trace, so one
            # directory holds both views of the run
            try:
                with open(os.path.join(profile_dir,
                                       "telemetry_phases.json"), "w") as f:
                    json.dump({"engineInstanceId": instance_id,
                               "phaseSeconds": {k: round(v, 6)
                                                for k, v in phases.items()}},
                              f, indent=2, sort_keys=True)
            except OSError:
                logger.warning("could not write telemetry phase table to "
                               "%s", profile_dir, exc_info=True)
        row = instances.get(instance_id)
        instances.update(EngineInstance(
            **{**row.__dict__, "status": "COMPLETED", "end_time": _now(),
               "runtime_conf": {**row.runtime_conf,
                                "train_stream":
                                    "on" if ctx.train_stream else "off",
                                **({"train_cursor": json.dumps(train_cursor)}
                                   if train_cursor is not None else {}),
                                "device": str(ctx.device),
                                **{f"phase_{k}_s": f"{v:.3f}"
                                   for k, v in phases.items()}}}))
        logger.info("Training completed; EngineInstance %s COMPLETED "
                    "(model blob %d bytes)", instance_id, len(blob))
        if phases:
            width = max(len(k) for k in phases)
            logger.info("Phase wall-clock:\n%s", "\n".join(
                f"  {k.ljust(width)}  {v:8.3f}s" for k, v in phases.items()))
        # the model blob persists the final state; snapshots are scratch
        if ctx.checkpoint_dir:
            FactorCheckpointer(ctx.checkpoint_dir).clear()
        return instance_id
    except Exception:
        row = instances.get(instance_id)
        if row is not None:
            instances.update(EngineInstance(
                **{**row.__dict__, "status": "ERROR", "end_time": _now()}))
        logger.error("Training failed:\n%s", traceback.format_exc())
        raise


def run_evaluation(
    ctx: WorkflowContext,
    evaluation: Evaluation,
    engine_params_list: Sequence[EngineParams],
    evaluation_class: str = "",
    generator_class: str = "",
    output_path: Optional[str] = None,
) -> MetricEvaluatorResult:
    """Evaluate every variant, pick the best, persist the ledger row
    (CoreWorkflow.runEvaluation :103-160 + EvaluationWorkflow.scala:32-45).
    A FakeRun's result (``no_save``) leaves the EVALCOMPLETED row only."""
    knobs.refuse_unported(knobs.EVAL)
    instances = ctx.storage.get_meta_data_evaluation_instances()
    instance_id = instances.insert(EvaluationInstance(
        id="", status="INIT", start_time=_now(), end_time=_now(),
        evaluation_class=evaluation_class,
        engine_params_generator_class=generator_class,
        batch=ctx.workflow_params.batch))
    try:
        workflow = FastEvalEngineWorkflow(evaluation.engine, ctx)
        # one read and one layout per (data-source, preparator) prefix and
        # fold, hoisted out of the per-variant loop
        workflow.prepare_shared_layouts(engine_params_list)
        engine_eval_data_sets = [
            (ep, workflow.eval(ep)) for ep in engine_params_list]
        evaluator = evaluation.evaluator
        if output_path:
            evaluator.output_path = output_path
        result = evaluator.evaluate_base(ctx, evaluation,
                                         engine_eval_data_sets)
        row = instances.get(instance_id)
        if getattr(result, "no_save", False):
            instances.update(EvaluationInstance(
                **{**row.__dict__, "status": "EVALCOMPLETED",
                   "end_time": _now()}))
        else:
            instances.update(EvaluationInstance(
                **{**row.__dict__, "status": "EVALCOMPLETED",
                   "end_time": _now(),
                   "evaluator_results": str(result),
                   "evaluator_results_html": result.to_html(),
                   "evaluator_results_json": result.to_json()}))
        logger.info("EvaluationInstance %s EVALCOMPLETED", instance_id)
        return result
    except Exception:
        row = instances.get(instance_id)
        if row is not None:
            instances.update(EvaluationInstance(
                **{**row.__dict__, "status": "ERROR", "end_time": _now()}))
        raise
