"""Training run bookkeeping around the engine (port of ``run_train`` in
``predictionio_tpu/workflow/core_workflow.py``).

A train run: insert EngineInstance(INIT), ``engine.train``, serialize the
models into the Models store keyed by the instance id, mark COMPLETED with
the phase table in ``runtime_conf``. A failure marks the row ERROR and
keeps its iteration snapshots, which the next run of the same
engine/variant resumes from (auto-resume). Single process: the
reference's multi-host branches have no counterpart yet, and evaluation
waits for the evaluation slice.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import traceback
from typing import Optional

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.storage import EngineInstance, Model
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.checkpoint import (
    FactorCheckpointer, latest_step_in, run_checkpoint_dir,
)
from predictionio_tpu_torch.workflow.context import WorkflowContext

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
    store.check_train_stream()
    instances = ctx.storage.get_meta_data_engine_instances()
    if resume_from is None and os.environ.get("PIO_AUTO_RESUME",
                                              "1") != "0":
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
    ctx.checkpoint_dir = run_checkpoint_dir(resume_from or instance_id)
    try:
        models = engine.train(ctx, engine_params)
        with ctx.phase("persist"):
            blob = model_io.serialize_models(
                models,
                check_finite=os.environ.get("PIO_FINITE_CHECK", "1") != "0")
            ctx.storage.get_model_data_models().insert(
                Model(id=instance_id, models=blob))
        phases = dict(ctx.phase_seconds)
        row = instances.get(instance_id)
        instances.update(EngineInstance(
            **{**row.__dict__, "status": "COMPLETED", "end_time": _now(),
               "runtime_conf": {**row.runtime_conf,
                                "train_stream": "off",
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
        FactorCheckpointer(ctx.checkpoint_dir).clear()
        return instance_id
    except Exception:
        row = instances.get(instance_id)
        if row is not None:
            instances.update(EngineInstance(
                **{**row.__dict__, "status": "ERROR", "end_time": _now()}))
        logger.error("Training failed:\n%s", traceback.format_exc())
        raise
