"""The ``pio`` console of the port, train and deploy verbs (port of
``predictionio_tpu/tools/cli.py``).

    python -m predictionio_tpu_torch.tools.cli train [--engine-dir DIR]
        [--variant engine.json] [--synthetic N [--synthetic-seed S]]
        [--resume-from ID] [--no-auto-resume] [--batch LABEL]
    python -m predictionio_tpu_torch.tools.cli deploy [--engine-dir DIR]
        [--engine-instance-id ID] [--ip HOST] [--port PORT] ...

Both run on the card unless ``PIO_TORCH_DEVICE=cpu`` asks for the CPU.
Storage is configured as in the reference (zero configuration: SQLite and
model files under ``$PIO_FS_BASEDIR``), so a store that the JAX package's
``pio app new`` and ``pio import`` filled trains here. ``app``,
``import``, ``eval`` and the event server wait for later slices.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from predictionio_tpu_torch import __version__

logger = logging.getLogger("pio")


def _info(msg: str) -> None:
    print(f"[INFO] {msg}")


def _error(msg: str) -> None:
    print(f"[ERROR] {msg}", file=sys.stderr)


def cmd_train(args) -> int:
    from predictionio_tpu_torch.workflow.context import (
        WorkflowContext, WorkflowParams,
    )
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.workflow_utils import (
        get_engine, read_engine_variant,
    )
    if args.synthetic:
        # the seeded zipfian generator replaces the event store
        # (data/synthetic.py env_config)
        os.environ["PIO_SYNTHETIC_EVENTS"] = str(args.synthetic)
        if args.synthetic_seed is not None:
            os.environ["PIO_SYNTHETIC_SEED"] = str(args.synthetic_seed)
    if args.no_auto_resume:
        os.environ["PIO_AUTO_RESUME"] = "0"
    engine_dir = os.path.abspath(args.engine_dir)
    variant = read_engine_variant(engine_dir, args.variant)
    engine = get_engine(variant["engineFactory"], base_dir=engine_dir)
    engine_params = engine.engine_params_from_json(variant)
    ctx = WorkflowContext(workflow_params=WorkflowParams(batch=args.batch))
    instance_id = run_train(
        ctx, engine, engine_params,
        engine_id=variant.get("id", "default"),
        engine_variant=variant.get("id", "default"),
        engine_factory=variant["engineFactory"],
        params_json=variant,
        resume_from=args.resume_from,
    )
    _info(f"Training completed. EngineInstance ID: {instance_id}")
    return 0


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.workflow.create_server import (
        QueryAPI, ServerConfig, serve,
    )
    from predictionio_tpu_torch.workflow.workflow_utils import (
        read_engine_variant,
    )
    engine_dir = os.path.abspath(args.engine_dir)
    variant = read_engine_variant(engine_dir, args.variant)
    config = ServerConfig(
        engine_instance_id=args.engine_instance_id,
        engine_dir=engine_dir,
        engine_id=variant.get("id", "default"),
        engine_variant=variant.get("id", "default"),
        batching=args.batching,
        batch_max_size=args.batch_max_size,
        batch_max_delay_ms=args.batch_max_delay_ms,
        batch_max_queue=args.batch_max_queue,
        drain_grace_s=args.drain_grace_s,
        serve_quant=args.serve_quant,
    )
    api = QueryAPI(config=config)
    _info(f"Engine is deployed and running. Engine API is live at "
          f"http://{args.ip}:{args.port}.")
    serve(api, host=args.ip, port=args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio", description="PredictionIO console, PyTorch port")
    p.add_argument("--verbose", action="store_true")
    sub = p.add_subparsers(dest="command")
    sub.add_parser("version", help="show version")

    def engine_flags(sp):
        sp.add_argument("--engine-dir", default=".",
                        help="engine directory (default: cwd)")
        sp.add_argument("--variant", default="engine.json",
                        help="engine variant JSON (default: engine.json)")

    sp = sub.add_parser("train", help="train an engine instance")
    engine_flags(sp)
    sp.add_argument("--batch", default="", help="batch label")
    sp.add_argument("--resume-from", default=None,
                    help="instance id of a crashed run whose iteration "
                         "snapshots should seed this training")
    sp.add_argument("--no-auto-resume", action="store_true",
                    help="do not auto-resume from a prior crashed run's "
                         "iteration checkpoints (sets PIO_AUTO_RESUME=0)")
    sp.add_argument("--synthetic", type=int, default=0,
                    help="train on N deterministic synthetic zipfian "
                         "ratings instead of the event store (sets "
                         "PIO_SYNTHETIC_EVENTS)")
    sp.add_argument("--synthetic-seed", type=int, default=None,
                    help="seed for --synthetic (default 7; sets "
                         "PIO_SYNTHETIC_SEED)")

    sp = sub.add_parser("deploy", help="deploy the latest engine instance")
    engine_flags(sp)
    sp.add_argument("--engine-instance-id", default=None)
    sp.add_argument("--ip", default="localhost")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--batching", choices=("auto", "on", "off"),
                    default="auto",
                    help="micro-batch concurrent queries (auto: on for "
                         "batch-capable algorithms)")
    sp.add_argument("--batch-max-size", type=int, default=64)
    sp.add_argument("--batch-max-delay-ms", type=float, default=2.0)
    sp.add_argument("--batch-max-queue", type=int, default=256,
                    help="admission control: 503 beyond this queue depth")
    sp.add_argument("--drain-grace-s", type=float, default=30.0,
                    help="SIGTERM graceful drain: seconds to wait for "
                         "in-flight batches before exiting")
    sp.add_argument("--serve-quant", choices=("auto", "on", "off"),
                    default="auto",
                    help="serve top-k from int8 factors with per-row fp32 "
                         "scales through the fused kernel (auto = on the "
                         "card, gated by the ranking-parity probe; "
                         "PIO_SERVE_QUANT overrides)")
    return p


_DISPATCH = {"train": cmd_train, "deploy": cmd_deploy}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.INFO)
    if args.command is None or args.command == "version":
        print(__version__)
        return 0
    try:
        return _DISPATCH[args.command](args)
    except (FileNotFoundError, ValueError) as e:
        # operational failures (no COMPLETED instance for deploy, bad
        # params, incompatible checkpoints, missing files) print one line
        # and exit 1; -v keeps the traceback reachable
        logger.debug("command failed", exc_info=True)
        _error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
