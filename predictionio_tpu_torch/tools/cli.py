"""The ``pio`` console of the port (port of
``predictionio_tpu/tools/cli.py``).

    python -m predictionio_tpu_torch.tools.cli app new NAME [--id N]
        [--description TEXT] [--access-key KEY]
    python -m predictionio_tpu_torch.tools.cli app {list,show,delete,
        data-delete,channel-new,channel-delete} ...
    python -m predictionio_tpu_torch.tools.cli accesskey {new,list,delete}
    python -m predictionio_tpu_torch.tools.cli eventserver [--ip HOST]
        [--port PORT] [--stats] [--telemetry] [--trace]
    python -m predictionio_tpu_torch.tools.cli import --appid N
        [--channel NAME] --input events.json
    python -m predictionio_tpu_torch.tools.cli export --appid N
        [--channel NAME] --output events.json
    python -m predictionio_tpu_torch.tools.cli train [--engine-dir DIR]
        [--variant engine.json] [--synthetic N [--synthetic-seed S]]
        [--resume-from ID] [--no-auto-resume] [--batch LABEL]
        [--devices N] [--coordinator HOST:PORT --num-processes N
        --process-id I] [--profile DIR] [--telemetry] [--trace]
    python -m predictionio_tpu_torch.tools.cli eval EVALUATION_CLASS
        [ENGINE_PARAMS_GENERATOR_CLASS] [--engine-dir DIR] [--batch LABEL]
        [--output-best-engine-params best.json]
    python -m predictionio_tpu_torch.tools.cli deploy [--engine-dir DIR]
        [--engine-instance-id ID] [--engines CONF_JSON] [--ip HOST]
        [--port PORT] [--partition I/N] [--feedback
        [--event-server-ip HOST] [--event-server-port PORT]
        [--accesskey KEY]] [--aot auto|on|off]
        [--shard-serving auto|on|off] [--foldin on|off]
        [--foldin-tick-ms MS] [--foldin-headroom N]
        [--foldin-item-headroom N] [--autotrain [--autotrain-dry-run]]
        [--telemetry] [--trace] [--waterfall] [--profile-dir DIR] ...
    python -m predictionio_tpu_torch.tools.cli router --backends URL,...
        [--ip HOST] [--port PORT] [--health-ms MS] [--deadline-ms MS]
        [--max-inflight N] [--cache on|off] [--cache-mb N]
        [--cache-ttl-ms MS] [--autopilot [--autopilot-dry-run]
        [--replica-cmd CMD]] [--autotrain [--autotrain-dry-run]
        [--engine-dir DIR] [--variant F] [--train-cmd CMD]]
        [--telemetry] [--trace]
    python -m predictionio_tpu_torch.tools.cli autopilot --router URL
        [--dry-run] [--replica-cmd CMD]
    python -m predictionio_tpu_torch.tools.cli autotrain --server URL
        [--engine-dir DIR] [--variant F] [--dry-run] [--train-cmd CMD]
    python -m predictionio_tpu_torch.tools.cli foldin [--engine-dir DIR]
        [--engine-instance-id ID] [--tick-ms MS] [--max-ticks N]
    python -m predictionio_tpu_torch.tools.cli undeploy [--ip HOST]
        [--port PORT]
    python -m predictionio_tpu_torch.tools.cli profile [URL] [--ms N]
        [-o SUBDIR]
    python -m predictionio_tpu_torch.tools.cli storageserver [--ip HOST]
        [--port PORT] [--key KEY] [--telemetry] [--trace]
    python -m predictionio_tpu_torch.tools.cli doctor [URL]
        [--targets URL,...]
    python -m predictionio_tpu_torch.tools.cli trace TRACE_ID
        --targets URL,...
    python -m predictionio_tpu_torch.tools.cli events --targets URL,...
        [--since-seq N] [--level L] [--category C] [--follow]
    python -m predictionio_tpu_torch.tools.cli monitor --targets URL,...
        [--once] [--record FILE] | --replay FILE
    python -m predictionio_tpu_torch.tools.cli incident --targets URL,...
        [--window 10m] [--trace ID]
    python -m predictionio_tpu_torch.tools.cli build [--engine-dir DIR]
        [--variant engine.json]
    python -m predictionio_tpu_torch.tools.cli run MODULE:CALLABLE
        [ARG ...] [--engine-dir DIR]
    python -m predictionio_tpu_torch.tools.cli {status,dashboard,
        adminserver,shell,template,unregister,upgrade} ...

``train``, ``eval`` and ``deploy`` run on the card unless
``PIO_TORCH_DEVICE=cpu`` asks for the CPU. ``train --devices N`` (-1:
all) trains block-sharded over a mesh of the world's devices, one per
process; ``--coordinator`` joins a ``torch.distributed`` job (NCCL on the
card, gloo on the CPU) where every process runs the same command with
its own ``--process-id``. ``deploy --shard-serving on`` serves from
row-sharded factors; ``deploy --partition i/N`` serves partition i of N
of the item rows, ``deploy --engines conf.json`` hosts several tenants,
and ``router`` fans queries out over replicas (a partition fleet's
answers merged). ``autotrain`` (or ``deploy --autotrain``, ``router
--autotrain``) retrains when drift, cursor lag, new events or age call
for it, gates the candidate against the live model and publishes it
through ``/reload``; ``autopilot`` (or ``router --autopilot``) scales
replicas, sheds, quarantines and profiles from the router's signals.
Every daemon, the router included, serves on the threaded transport or,
with ``PIO_TRANSPORT=async``, on the asyncio one. The event server, the storage
server, the app and key commands, ``import``, ``export`` and the
operator tools (``doctor``, ``trace``, ``events``, ``monitor``,
``incident``, which read live daemons over HTTP) work on the host and
never touch the card, as does ``lint``, the port's static analysis. A
reference variable that asks for a feature the port lacks (``knobs.py``
refuses none today) would make the verb exit 1 with a message naming
it, before any work. ``PIO_SERVE_DEVICE_MS`` is read by ``deploy``: an
fp32 model whose device probe is slower serves from the host, shown in
``GET /``. ``--telemetry``, ``--trace`` and ``--waterfall`` set
``PIO_TELEMETRY``, ``PIO_TRACE`` and ``PIO_WATERFALL`` to 1, as in the
reference. Storage is configured as in the reference (zero
configuration: SQLite and model files under ``$PIO_FS_BASEDIR``), so a
store that either package's ``pio app new`` and ``pio import`` filled
reads in the other.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from predictionio_tpu_torch import __version__, knobs
from predictionio_tpu_torch.tools import apps as app_cmds
from predictionio_tpu_torch.tools.apps import CommandError

logger = logging.getLogger("pio")


def _info(msg: str) -> None:
    print(f"[INFO] {msg}")


def _error(msg: str) -> None:
    print(f"[ERROR] {msg}", file=sys.stderr)


def _apply_telemetry_env(args) -> None:
    """Map the observability flags onto their env knobs (the library
    layers read PIO_TELEMETRY / PIO_TRACE, so in-process callers and
    daemons honor the same switches)."""
    if getattr(args, "telemetry", False):
        os.environ["PIO_TELEMETRY"] = "1"
    if getattr(args, "trace", False):
        os.environ["PIO_TRACE"] = "1"


def _make_context(batch: str = "", devices: int = 0,
                  profile_dir: Optional[str] = None,
                  coordinator: str = "", num_processes: int = 0,
                  process_id: int = 0):
    """The train's context: a mesh when ``devices`` asks for more than
    one device (-1: the whole world) or a ``coordinator`` joins a job."""
    from predictionio_tpu_torch.workflow.context import (
        WorkflowContext, WorkflowParams,
    )
    mesh = None
    if coordinator:
        from predictionio_tpu_torch.parallel.mesh import init_distributed
        init_distributed(coordinator, num_processes, process_id)
        if not devices:
            devices = -1  # the whole job's mesh
    if devices and (devices > 1 or devices < 0):
        from predictionio_tpu_torch.parallel.mesh import get_mesh
        mesh = get_mesh(None if devices < 0 else devices)
    return WorkflowContext(
        workflow_params=WorkflowParams(batch=batch, profile_dir=profile_dir),
        mesh=mesh)


def cmd_build(args) -> int:
    """Validate the engine variant and its factory's import (the sbt
    compile step collapses to an import check;
    commands/Engine.scala:65-161)."""
    from predictionio_tpu_torch.workflow.workflow_utils import (
        get_engine, read_engine_variant,
    )
    engine_dir = os.path.abspath(args.engine_dir)
    variant = read_engine_variant(engine_dir, args.variant)
    engine = get_engine(variant["engineFactory"], base_dir=engine_dir)
    engine.engine_params_from_json(variant)
    _info(f"Engine {variant['engineFactory']} validated "
          f"(variant {variant['id']}).")
    _info("Build finished successfully. (Python engines need no compile.)")
    return 0


def cmd_run(args) -> int:
    """Run an arbitrary main class (console run, Console.scala:367-389):
    ``main_class`` resolves with the engine directory first on the path;
    its return value is the exit code."""
    from predictionio_tpu_torch.workflow.workflow_utils import load_object
    target = load_object(args.main_class,
                         base_dir=os.path.abspath(args.engine_dir))
    rv = target(*args.args) if callable(target) else None
    return int(rv or 0)


def cmd_shell(args) -> int:
    """A Python shell with the configured Storage preloaded (bin/pio-shell
    role: the reference opens a spark-shell with the pio assemblies on
    its classpath): ``storage``, ``store`` (the event-store facades),
    ``Storage`` and ``torch``. With stdin not a terminal it runs what it
    reads and exits."""
    import torch

    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.storage import Storage

    ns = {"storage": Storage(), "store": store, "torch": torch,
          "Storage": Storage, "__name__": "__console__"}
    if not sys.stdin.isatty():
        exec(compile(sys.stdin.read(), "<stdin>", "exec"), ns)
        return 0
    cuda = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "no card visible")
    banner = ("predictionio_tpu_torch shell\n"
              "  storage  -> configured Storage (env-driven)\n"
              "  store    -> event store facades "
              "(find/find_columnar/aggregate_properties)\n"
              f"  torch    -> torch {torch.__version__} ({cuda})")
    try:
        from IPython import start_ipython
        start_ipython(argv=[], user_ns=ns, display_banner=True)
    except ImportError:
        import code
        code.interact(banner=banner, local=ns)
    return 0


def cmd_template(args) -> int:
    """Template gallery moved to the web in the reference too
    (Console.scala:546-560)."""
    _info("Engine templates ship inside predictionio_tpu_torch.models.*:")
    _info("  recommendation    - ALS matrix factorization (MovieLens-style)")
    _info("  classification    - Naive Bayes over $set user properties")
    _info("  similarproduct    - implicit ALS item-vector similarity")
    _info("  ecommerce         - explicit ALS + business-rule filters")
    _info("Instantiate one by pointing engine.json's engineFactory at its "
          "factory, e.g. predictionio_tpu_torch.models.recommendation."
          "engine:RecommendationEngine (a predictionio_tpu.* path maps to "
          "the same factory).")
    _info("Demo engines (the reference's examples/experimental set) live "
          "in predictionio_tpu_torch.examples.* — helloworld, regression, "
          "friend_recommendation, dimsum, recommendation_variants, "
          "similarproduct_variants, recommended_user, refactor_test, apps, "
          "movielens, stock; see that package's docstring for the map.")
    return 0


def cmd_unregister(args) -> int:
    """Console.scala:170-175 parity: the verb parses but engine
    registration metadata no longer exists (the reference removed its
    sbt registry; its own dispatch falls through to help + exit 1)."""
    _error("Nothing to unregister: engines are not registered — `pio "
           "build` validates in place and `pio train --engine-dir` points "
           "at the engine directory directly.")
    return 1


def cmd_upgrade(args) -> int:
    """Console.scala:396-399 + :664-666 parity."""
    _error("Upgrade is no longer supported")
    return 1


def cmd_train(args) -> int:
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
    _apply_telemetry_env(args)
    if args.coordinator:
        if args.num_processes < 1:
            _error("--coordinator requires --num-processes >= 1")
            return 1
        if not 0 <= args.process_id < args.num_processes:
            _error("--process-id must be in [0, --num-processes)")
            return 1
    engine_dir = os.path.abspath(args.engine_dir)
    variant = read_engine_variant(engine_dir, args.variant)
    engine = get_engine(variant["engineFactory"], base_dir=engine_dir)
    engine_params = engine.engine_params_from_json(variant)
    ctx = _make_context(batch=args.batch, devices=args.devices,
                        profile_dir=args.profile or None,
                        coordinator=args.coordinator,
                        num_processes=args.num_processes,
                        process_id=args.process_id)
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


def cmd_eval(args) -> int:
    from predictionio_tpu_torch.workflow.context import (
        WorkflowContext, WorkflowParams,
    )
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
    from predictionio_tpu_torch.workflow.workflow_utils import (
        get_engine_params_generator, get_evaluation,
    )
    engine_dir = os.path.abspath(args.engine_dir)
    evaluation = get_evaluation(args.evaluation_class, base_dir=engine_dir)
    if args.engine_params_generator_class:
        params_list = get_engine_params_generator(
            args.engine_params_generator_class,
            base_dir=engine_dir).engine_params_list
    else:
        # an Evaluation may carry its own list (FakeRun does)
        params_list = getattr(evaluation, "engine_params_list", None)
        if params_list is None:
            _error("No EngineParamsGenerator given and the Evaluation "
                   "defines no engine_params_list.")
            return 1
    ctx = WorkflowContext(workflow_params=WorkflowParams(batch=args.batch))
    result = run_evaluation(
        ctx, evaluation, params_list,
        evaluation_class=args.evaluation_class,
        generator_class=args.engine_params_generator_class or "",
        output_path=args.output_best_engine_params or "best.json",
    )
    print(str(result))
    return 0


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.workflow.create_server import (
        QueryAPI, ServerConfig, serve,
    )
    from predictionio_tpu_torch.workflow.workflow_utils import (
        read_engine_variant,
    )
    _apply_telemetry_env(args)
    if args.waterfall:
        # per-request latency waterfalls + /debug/slow.json
        os.environ["PIO_WATERFALL"] = "1"
    if args.profile_dir:
        # where POST /debug/profile captures land
        os.environ["PIO_PROFILE_DIR"] = args.profile_dir
    engine_dir = os.path.abspath(args.engine_dir)
    tenants = ()
    if args.engines:
        # multi-tenant: each tenant's spec names its own engine; the
        # engine directory's engine.json is not read
        from predictionio_tpu_torch.serving.registry import (
            load_engines_conf,
        )
        tenants = load_engines_conf(args.engines)
        variant = {}
    else:
        variant = read_engine_variant(engine_dir, args.variant)
    config = ServerConfig(
        engine_instance_id=args.engine_instance_id,
        engine_dir=engine_dir,
        engine_id=variant.get("id", "default"),
        engine_variant=variant.get("id", "default"),
        tenants=tenants,
        partition=args.partition,
        feedback=args.feedback,
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        access_key=args.accesskey,
        batching=args.batching,
        batch_max_size=args.batch_max_size,
        batch_max_delay_ms=args.batch_max_delay_ms,
        batch_max_queue=args.batch_max_queue,
        drain_grace_s=args.drain_grace_s,
        serve_quant=args.serve_quant,
        shard_serving=args.shard_serving,
        aot=args.aot,
        foldin=args.foldin,
        foldin_tick_ms=args.foldin_tick_ms,
        foldin_headroom=args.foldin_headroom,
        foldin_item_headroom=args.foldin_item_headroom,
    )
    api = QueryAPI(config=config)
    at = None
    if args.autotrain and not tenants:
        at = _embedded_autotrain(api, config, variant, args.autotrain_dry_run)
    _info(f"Engine is deployed and running. Engine API is live at "
          f"http://{args.ip}:{args.port}.")
    try:
        serve(api, host=args.ip, port=args.port)
    finally:
        if at is not None:
            at.close()
    return 0


def _start_loop(loop, thread_name: str, what: str):
    """Run an embedded control loop (autotrain, autopilot) on a daemon
    thread of the host process."""
    import threading
    threading.Thread(target=loop.run, name=thread_name, daemon=True).start()
    _info(f"{what} is " + ("DRY-RUN (journals would-have decisions only)."
                           if loop.config.dry_run else "live."))
    return loop


def _embedded_autotrain(api, config, variant: dict, dry_run: bool):
    """``deploy --autotrain``: the continuous-training loop in the serving
    process. Its retrains run ``run_train`` on a thread pinned to the
    deploy's device (a fresh context over the deploy's storage and
    device, with the deploy's engine and params), and its publish is the
    in-place hot swap."""
    from predictionio_tpu_torch.workflow.autotrain import (
        Autotrain, AutotrainConfig, LocalDeployControl, ThreadTrainer,
    )
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    def retrain() -> str:
        ctx = WorkflowContext(storage=api.storage, device=api.device)
        return run_train(
            ctx, api.engine, api.engine_params,
            engine_id=config.engine_id,
            engine_variant=config.engine_variant,
            engine_factory=variant.get("engineFactory", ""),
            params_json=variant)

    at = Autotrain(
        LocalDeployControl(api), storage=api.storage,
        engine_params=api.engine_params,
        trainer=ThreadTrainer(retrain, device=api.device),
        config=AutotrainConfig(dry_run=dry_run),
        engine_id=config.engine_id,
        engine_variant=config.engine_variant)
    api.attach_autotrain(at)
    return _start_loop(at, "pio-autotrain", "Autotrain")


def cmd_router(args) -> int:
    """The fleet front door (workflow/router.py): /queries.json fanned
    out to N query-server replicas with health-driven membership,
    per-request failover, load shedding and the coordinated /reload
    barrier; a partition fleet's answers scattered and merged."""
    from predictionio_tpu_torch.workflow.router import (
        RouterAPI, RouterConfig, serve,
    )
    _apply_telemetry_env(args)
    config = RouterConfig(
        backends=tuple(_parse_targets(args.backends, flag="--backends")),
        ip=args.ip, port=args.port,
        health_ms=args.health_ms,
        deadline_ms=args.deadline_ms,
        max_inflight=args.max_inflight,
        cache=args.cache,
        cache_mb=args.cache_mb,
        cache_ttl_ms=args.cache_ttl_ms)
    api = RouterAPI(config)
    loops = []
    if args.autopilot:
        loops.append(_embedded_autopilot(api, args))
    if args.autotrain:
        loops.append(_router_autotrain(api, args))
    _info(f"Router is started at {args.ip}:{args.port} over "
          f"{len(api.backends)} backend(s).")
    try:
        serve(api, host=args.ip, port=args.port)
    finally:
        for loop in loops:
            loop.close()
    return 0


def _embedded_autopilot(api, args):
    """``router --autopilot``: the fleet control loop in the router
    process, steering it through direct calls; ``--replica-cmd`` gives it
    a pool of local replica processes to scale."""
    from predictionio_tpu_torch.workflow.autopilot import (
        Autopilot, AutopilotConfig, LocalRouterControl,
        SubprocessReplicaPool,
    )
    pool = (SubprocessReplicaPool(args.replica_cmd)
            if args.replica_cmd else None)
    ap = Autopilot(LocalRouterControl(api),
                   config=AutopilotConfig(dry_run=args.autopilot_dry_run),
                   pool=pool)
    api.attach_autopilot(ap)
    return _start_loop(ap, "pio-autopilot", "Autopilot")


def _router_autotrain(api, args):
    """``router --autotrain``: retrains run as ``pio train``
    subprocesses (``--train-cmd`` overrides), accepted candidates publish
    through this router's zero-drop ``/reload`` barrier."""
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.workflow.autotrain import (
        Autotrain, AutotrainConfig, SubprocessTrainer,
        default_train_command,
    )
    from predictionio_tpu_torch.workflow.autotrain import (
        LocalRouterControl as AutotrainRouterControl,
    )
    from predictionio_tpu_torch.workflow.workflow_utils import (
        get_engine, read_engine_variant,
    )
    engine_dir = os.path.abspath(args.engine_dir)
    var = read_engine_variant(engine_dir, args.variant)
    engine = get_engine(var["engineFactory"], base_dir=engine_dir)
    at = Autotrain(
        AutotrainRouterControl(api), storage=get_storage(),
        engine_params=engine.engine_params_from_json(var),
        trainer=SubprocessTrainer(
            args.train_cmd or default_train_command(engine_dir,
                                                    args.variant)),
        config=AutotrainConfig(dry_run=args.autotrain_dry_run),
        engine_id=var.get("id", "default"),
        engine_variant=var.get("id", "default"))
    api.attach_autotrain(at)
    return _start_loop(at, "pio-autotrain", "Autotrain")


def cmd_autopilot(args) -> int:
    """The fleet control loop (workflow/autopilot.py) over a running
    router's admin routes; Ctrl-C stops it."""
    from predictionio_tpu_torch.workflow.autopilot import run_autopilot
    _apply_telemetry_env(args)
    run_autopilot(args.router, dry_run=args.dry_run,
                  replica_cmd=args.replica_cmd)
    return 0


def cmd_autotrain(args) -> int:
    """The continuous-training loop (workflow/autotrain.py) over a
    running deploy server or router; Ctrl-C stops it."""
    from predictionio_tpu_torch.workflow.autotrain import run_autotrain
    _apply_telemetry_env(args)
    run_autotrain(args.server, engine_dir=args.engine_dir,
                  variant=args.variant, dry_run=args.dry_run,
                  train_cmd=args.train_cmd)
    return 0


def cmd_foldin(args) -> int:
    """The standalone fold-in runner (realtime/foldin.py run_standalone):
    the latest COMPLETED instance's model in this process, the tail ->
    solve -> publish pipeline against the live event stream, and its
    freshness, lag and drift; publication stays in the local copy and
    the cursor in its own ``standalone`` namespace. ``pio deploy
    --foldin on`` is the serving form. Exit 0 clean, 1 when the store has
    no incremental tail."""
    from predictionio_tpu_torch.realtime.foldin import run_standalone
    return run_standalone(
        engine_dir=args.engine_dir, variant=args.variant,
        engine_instance_id=args.engine_instance_id,
        tick_ms=args.tick_ms, max_ticks=args.max_ticks or None)


def cmd_undeploy(args) -> int:
    from predictionio_tpu_torch.workflow.create_server import undeploy
    if undeploy(args.ip, args.port):
        _info(f"Undeployed server at {args.ip}:{args.port}.")
        return 0
    _error(f"Undeploy failed: nothing listening at {args.ip}:{args.port}.")
    return 1


def cmd_profile(args) -> int:
    """Bounded on-demand profile capture from a LIVE daemon
    (tools/profile.py -> POST /debug/profile). Exit 0 non-empty artifact
    / 1 failed / 2 unreachable."""
    from predictionio_tpu_torch.tools.profile import run_profile
    url = args.url or f"http://{args.ip}:{args.port}"
    return run_profile(url, ms=args.ms, out_dir=args.out or None,
                       timeout=args.timeout)


def cmd_doctor(args) -> int:
    """One-screen operator verdict against a running daemon's
    observability surface (tools/doctor.py): health, readiness, queue
    depth, serve p99, circuit breakers, degraded batches, post-warmup
    kernel builds, device memory headroom, trace buffer, and the router
    line when the target is a router. ``--targets url,...`` runs the
    verdict over every member of a fleet and exits with the worst code.
    Exit 0 green / 1 red / 2 unreachable."""
    from predictionio_tpu_torch.tools.doctor import (
        run_doctor, run_doctor_fleet,
    )
    if args.targets:
        return run_doctor_fleet(_parse_targets(args.targets),
                                timeout=args.timeout)
    url = args.url or f"http://{args.ip}:{args.port}"
    return run_doctor(url, timeout=args.timeout)


def _parse_targets(raw: str, flag: str = "--targets") -> List[str]:
    targets = [t.strip() for t in (raw or "").split(",") if t.strip()]
    if not targets:
        raise CommandError(
            f"{flag} requires at least one daemon base URL "
            "(comma-separated, e.g. "
            "http://host:8000,http://host:7070)")
    return targets


def cmd_trace(args) -> int:
    """Fleet trace assembly (common/traceview.py): one trace id fanned
    out to every target's /traces.json?trace_id=, the spans joined
    across processes with clock-skew correction and drawn as ONE tree.
    Exit 0 assembled / 1 not found / 2 every target unreachable."""
    from predictionio_tpu_torch.common.traceview import run_trace
    return run_trace(args.trace_id, _parse_targets(args.targets),
                     timeout=args.timeout)


def cmd_events(args) -> int:
    """Fleet journal merge (common/traceview.py): every target's
    /debug/events.json, oldest first; --follow keeps polling with
    per-target since_seq cursors. Exit 0 / 2 every target unreachable."""
    from predictionio_tpu_torch.common.traceview import run_events
    return run_events(
        _parse_targets(args.targets), since_seq=args.since_seq,
        category=args.category or None, level=args.level or None,
        follow=args.follow, interval_s=args.interval,
        timeout=args.timeout)


def cmd_monitor(args) -> int:
    """One-screen fleet view (tools/monitor.py): per target QPS, p99 and
    error rate from each daemon's own history rings
    (/debug/history.json), SLO burn from live gauges, and the doctor's
    state flags. --once prints one frame; --record FILE appends each
    frame's fetches as a JSON line; --replay FILE re-renders a recording
    offline. Exit 0 / 2 every target unreachable."""
    from predictionio_tpu_torch.tools.monitor import run_monitor
    if args.replay:
        return run_monitor([], replay=args.replay,
                           interval_s=args.interval)
    return run_monitor(
        _parse_targets(args.targets), once=args.once,
        interval_s=args.interval, record=args.record or None,
        timeout=args.timeout)


def cmd_incident(args) -> int:
    """One ordered incident timeline for a fleet (tools/incident.py):
    journal WARN/RED events, metric change points over each target's
    history rings, slow-ring exemplars and the traces they reference,
    clock-skew corrected, oldest first. Exit 0 clean window / 1 incident
    evidence found / 2 every target unreachable."""
    from predictionio_tpu_torch.tools.incident import run_incident
    return run_incident(
        _parse_targets(args.targets), window=args.window,
        trace_id=args.trace or None, timeout=args.timeout)


def cmd_lint(args) -> int:
    """Static analysis of the port (tools/analyze): timing honesty,
    implicit host syncs and gather bounds, lock ordering, declaration
    cross-checks and debug-surface unity over ``predictionio_tpu_torch/``
    and ``chip_smoke.py``. Exit 0 clean / 1 findings / 2 internal error.
    Stdlib-only: runs without touching torch's device or the card."""
    from predictionio_tpu_torch.tools.analyze.runner import main as lint_main
    argv = []
    if args.json:
        argv.append("--json")
    if args.update_baseline:
        argv.append("--update-baseline")
    if args.list_passes:
        argv.append("--list")
    if args.root:
        argv += ["--root", args.root]
    if args.baseline:
        argv += ["--baseline", args.baseline]
    return lint_main(argv)


def cmd_storageserver(args) -> int:
    """Serve this node's storage over HTTP so other processes and hosts
    can point a ``remote`` source at it (data/storage/remote.py).
    SIGTERM drains: /readyz answers 503, the listener stops accepting,
    and the backing event store flushes its WAL buffers before exit."""
    from predictionio_tpu_torch.data.api.http import serve_forever
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.data.storage.remote import StorageRPCAPI
    _apply_telemetry_env(args)
    key = args.key or os.environ.get("PIO_STORAGE_SERVER_KEY") or None
    storage = get_storage()

    def flush_events():
        try:
            events = storage.get_events()
            if hasattr(events, "close"):
                events.close()
            _info("Storage server drained (event buffers flushed).")
        except Exception as e:  # a backend's own flush failure
            _error(f"Drain-time flush failed: {e}")

    _info(f"Storage server is started at {args.ip}:{args.port}"
          f"{' (key auth on)' if key else ''}.")
    serve_forever(StorageRPCAPI(storage, key=key),
                  host=args.ip, port=args.port, on_drain=flush_events)
    return 0


def cmd_eventserver(args) -> int:
    from predictionio_tpu_torch.data.api import EventAPI, EventServerConfig
    from predictionio_tpu_torch.data.api.http import serve_forever
    _apply_telemetry_env(args)
    api = EventAPI(config=EventServerConfig(
        ip=args.ip, port=args.port, stats=args.stats))
    _info(f"Event Server is started at {args.ip}:{args.port}.")
    serve_forever(api, host=args.ip, port=args.port)
    return 0


def cmd_dashboard(args) -> int:
    from predictionio_tpu_torch.data.api.http import serve_forever
    from predictionio_tpu_torch.tools.dashboard import DashboardAPI
    _info(f"Dashboard is started at {args.ip}:{args.port}.")
    serve_forever(DashboardAPI(server_key=args.key or None),
                  host=args.ip, port=args.port)
    return 0


def cmd_adminserver(args) -> int:
    from predictionio_tpu_torch.data.api.http import serve_forever
    from predictionio_tpu_torch.tools.admin import AdminAPI
    _info(f"Admin server is started at {args.ip}:{args.port}.")
    serve_forever(AdminAPI(server_key=args.key or None),
                  host=args.ip, port=args.port)
    return 0


def cmd_status(args) -> int:
    """Verify installation + storage (commands/Management.scala:181,
    Storage.verifyAllDataObjects); the device line names the card the
    train and deploy verbs would run on."""
    import torch

    from predictionio_tpu_torch import device
    from predictionio_tpu_torch.data.storage import get_storage
    _info(f"PredictionIO-TPU PyTorch port {__version__}")
    try:
        dev = device.resolve()
    except RuntimeError as e:
        _error(str(e))
        return 1
    _info(f"torch {torch.__version__}; device: {device.describe(dev)}")
    _info("Verifying configured storage backend(s)...")
    try:
        get_storage().verify_all_data_objects()
    except Exception as e:
        _error(f"Unable to connect to all storage backends: {e}")
        return 1
    _info("Your system is all ready to go.")
    return 0


def cmd_app(args) -> int:
    from predictionio_tpu_torch.data.storage import get_storage
    storage = get_storage()
    if args.app_command == "new":
        d = app_cmds.create(args.name, app_id=args.id,
                            description=args.description,
                            access_key=args.access_key or "",
                            storage=storage)
        _info(f"Initialized Event Store for this app ID: {d.app.id}.")
        _info("Created a new app:")
        _info(f"      Name: {d.app.name}")
        _info(f"        ID: {d.app.id}")
        _info(f"Access Key: {d.keys[0].key}")
    elif args.app_command == "list":
        _info(f"{'Name':20} | {'ID':4} | Access Key | Allowed Event(s)")
        for d in app_cmds.list_apps(storage):
            for k in d.keys:
                allowed = ",".join(k.events) if k.events else "(all)"
                _info(f"{d.app.name:20} | {d.app.id:4} | {k.key} | {allowed}")
        _info(f"Finished listing {len(app_cmds.list_apps(storage))} app(s).")
    elif args.app_command == "show":
        d, channels = app_cmds.show(args.name, storage=storage)
        _info(f"    App Name: {d.app.name}")
        _info(f"      App ID: {d.app.id}")
        _info(f" Description: {d.app.description or ''}")
        for k in d.keys:
            allowed = ",".join(k.events) if k.events else "(all)"
            _info(f"  Access Key: {k.key} | {allowed}")
        for c in channels:
            _info(f"     Channel: {c.name} (ID {c.id})")
    elif args.app_command == "delete":
        if not args.force and not _confirm(
                f"Delete app {args.name} and ALL of its data?"):
            return 1
        app_cmds.delete(args.name, storage=storage)
        _info(f"App {args.name} deleted.")
    elif args.app_command == "data-delete":
        if not args.force and not _confirm(
                f"Delete data of app {args.name}?"):
            return 1
        app_cmds.data_delete(args.name, channel=args.channel,
                             delete_all=args.all, storage=storage)
        _info(f"Data of app {args.name} deleted.")
    elif args.app_command == "channel-new":
        c = app_cmds.channel_new(args.name, args.channel, storage=storage)
        _info(f"Channel {c.name} (ID {c.id}) created for app {args.name}.")
    elif args.app_command == "channel-delete":
        if not args.force and not _confirm(
                f"Delete channel {args.channel} of app {args.name}?"):
            return 1
        app_cmds.channel_delete(args.name, args.channel, storage=storage)
        _info(f"Channel {args.channel} deleted.")
    return 0


def cmd_accesskey(args) -> int:
    from predictionio_tpu_torch.data.storage import get_storage
    storage = get_storage()
    if args.accesskey_command == "new":
        k = app_cmds.accesskey_new(args.app_name, key=args.key or "",
                                   events=args.event or (), storage=storage)
        _info(f"Created new access key: {k.key}")
    elif args.accesskey_command == "list":
        for k in app_cmds.accesskey_list(args.app_name, storage=storage):
            allowed = ",".join(k.events) if k.events else "(all)"
            _info(f"{k.key} | app {k.appid} | {allowed}")
    elif args.accesskey_command == "delete":
        app_cmds.accesskey_delete(args.key, storage=storage)
        _info(f"Deleted access key {args.key}.")
    return 0


def cmd_import(args) -> int:
    from predictionio_tpu_torch.tools.transfer import file_to_events
    n = file_to_events(args.input, args.appid, channel=args.channel)
    _info(f"Imported {n} events.")
    return 0


def cmd_export(args) -> int:
    from predictionio_tpu_torch.tools.transfer import events_to_file
    n = events_to_file(args.output, args.appid, channel=args.channel)
    _info(f"Exported {n} events.")
    return 0


def _confirm(prompt: str) -> bool:
    answer = input(f"{prompt} (Y/n) ")
    return answer.strip().lower() in ("", "y", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio", description="PredictionIO console, PyTorch port")
    p.add_argument("--verbose", action="store_true")
    sub = p.add_subparsers(dest="command")
    sub.add_parser("version", help="show version")
    sub.add_parser("status", help="verify installation and storage")

    def telemetry_flags(sp):
        sp.add_argument("--telemetry", action="store_true",
                        help="record hot-path metrics (sets "
                             "PIO_TELEMETRY=1; GET /metrics serves "
                             "Prometheus text either way)")
        sp.add_argument("--trace", action="store_true",
                        help="originate request traces (sets PIO_TRACE=1; "
                             "propagated X-PIO-Trace headers are always "
                             "honored); GET /traces.json")

    def engine_flags(sp):
        sp.add_argument("--engine-dir", default=".",
                        help="engine directory (default: cwd)")
        sp.add_argument("--variant", default="engine.json",
                        help="engine variant JSON (default: engine.json)")

    sp = sub.add_parser("build", help="validate an engine")
    engine_flags(sp)

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
    sp.add_argument("--devices", type=int, default=0,
                    help="train block-sharded over the first N devices "
                         "of the job (default: one device; -1 = all)")
    sp.add_argument("--coordinator", default="",
                    help="host:port of process 0 for a multi-process "
                         "train; run the same command in every process "
                         "with its own --process-id (torch.distributed: "
                         "NCCL on the card, gloo on the CPU)")
    sp.add_argument("--num-processes", type=int, default=0,
                    help="processes in the multi-process job")
    sp.add_argument("--process-id", type=int, default=0,
                    help="this process's rank in [0, --num-processes)")
    sp.add_argument("--profile", default="",
                    help="write a torch.profiler Chrome trace of the "
                         "train (and telemetry_phases.json) to this "
                         "directory")
    telemetry_flags(sp)

    sp = sub.add_parser("eval", help="run an evaluation")
    sp.add_argument("evaluation_class")
    sp.add_argument("engine_params_generator_class", nargs="?", default="")
    sp.add_argument("--engine-dir", default=".")
    sp.add_argument("--batch", default="")
    sp.add_argument("--output-best-engine-params", default="",
                    help="where to write best.json")

    sp = sub.add_parser("deploy", help="deploy the latest engine instance")
    engine_flags(sp)
    sp.add_argument("--engine-instance-id", default=None)
    sp.add_argument("--engines", default=None, metavar="CONF_JSON",
                    help="multi-tenant deploy: a JSON file of tenant "
                         "specs (serving/registry.py); one process hosts "
                         "N engine instances, each with its own batcher "
                         "queue, memory budget and access-key admission")
    sp.add_argument("--ip", default="localhost")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--partition", default="",
                    help="partition-routed deploy scope i/N (e.g. 0/2): "
                         "serve only the owned contiguous item rows; "
                         "`pio router` scatters each query over all N "
                         "partitions and merges the answers exactly "
                         "(PIO_DEPLOY_PARTITION overrides an empty value)")
    sp.add_argument("--feedback", action="store_true",
                    help="post each answered query as a predict event "
                         "to the event server")
    sp.add_argument("--event-server-ip", default="localhost")
    sp.add_argument("--event-server-port", type=int, default=7070)
    sp.add_argument("--accesskey", default=None,
                    help="the feedback events' access key")
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
    sp.add_argument("--shard-serving", choices=("auto", "on", "off"),
                    default="auto",
                    help="row-shard the deployed factor matrices over the "
                         "job's devices and serve top-k from the shards "
                         "(B1 per shard, one B2; bit-identical answers; "
                         "auto = multi-card worlds only, replicated "
                         "during /reload; PIO_SERVE_SHARD overrides)")
    sp.add_argument("--aot", choices=("auto", "on", "off"), default="auto",
                    help="run every bucket's serving call and, with "
                         "fold-in, kernel A at every fold-in bucket once "
                         "before /readyz says ready (serving/aot.py; "
                         "auto = on the card; PIO_AOT=0/1 overrides)")
    sp.add_argument("--foldin", choices=("on", "off"), default="off",
                    help="run the realtime fold-in worker in process "
                         "(realtime/foldin.py): tail the event store, "
                         "re-solve dirty users and unseen items with the "
                         "ALS half-step and publish the rows into the "
                         "live model (PIO_FOLDIN=0/1 overrides)")
    sp.add_argument("--foldin-tick-ms", type=float, default=0.0,
                    help="fold-in tick in ms (0 = PIO_FOLDIN_TICK_MS or "
                         "250)")
    sp.add_argument("--foldin-headroom", type=int, default=0,
                    help="user rows padded for fold-in appends (0 = "
                         "PIO_FOLDIN_HEADROOM or 1024)")
    sp.add_argument("--foldin-item-headroom", type=int, default=0,
                    help="item rows padded for unseen items (0 = "
                         "PIO_FOLDIN_ITEM_HEADROOM or 1024)")
    sp.add_argument("--waterfall", action="store_true",
                    help="sample per-request latency waterfalls "
                         "(GET /debug/slow.json + per-stage histograms; "
                         "sets PIO_WATERFALL=1)")
    sp.add_argument("--profile-dir", default="",
                    help="directory for POST /debug/profile capture "
                         "artifacts (sets PIO_PROFILE_DIR)")
    sp.add_argument("--autotrain", action="store_true",
                    help="run the continuous-training loop in this "
                         "process: retrains on a thread on the deploy's "
                         "device, validated candidates published by the "
                         "in-place swap (workflow/autotrain.py)")
    sp.add_argument("--autotrain-dry-run", action="store_true",
                    help="the embedded autotrain journals would-have "
                         "retrain decisions without training")
    telemetry_flags(sp)

    sp = sub.add_parser(
        "foldin",
        help="standalone realtime fold-in: tail the event store and "
             "re-solve dirty users against the latest trained model in "
             "this process (the dry-run form of `pio deploy --foldin "
             "on`; exit 0 clean / 1 unsupported store)")
    engine_flags(sp)
    sp.add_argument("--engine-instance-id", default=None)
    sp.add_argument("--tick-ms", type=float, default=0.0,
                    help="tick in ms (0 = PIO_FOLDIN_TICK_MS or 250)")
    sp.add_argument("--max-ticks", type=int, default=0,
                    help="stop after N ticks (0 = run until Ctrl-C)")

    sp = sub.add_parser(
        "router",
        help="start the replica-fleet front door: fan /queries.json out "
             "to N query-server replicas with failover, load shedding "
             "and the coordinated /reload barrier (workflow/router.py)")
    sp.add_argument("--backends", required=True,
                    help="comma-separated query-server base URLs, e.g. "
                         "http://host:8000,http://host:8001")
    sp.add_argument("--ip", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8100)
    sp.add_argument("--health-ms", type=float, default=0.0,
                    help="membership poll cadence in ms (0 = "
                         "PIO_ROUTER_HEALTH_MS or 500)")
    sp.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-query deadline budget in ms, propagated "
                         "as X-PIO-Deadline-Ms (0 = "
                         "PIO_ROUTER_DEADLINE_MS or 2000)")
    sp.add_argument("--max-inflight", type=int, default=0,
                    help="admission ceiling before 503 + Retry-After "
                         "(0 = PIO_ROUTER_MAX_INFLIGHT or 256)")
    sp.add_argument("--cache", choices=("on", "off"), default="",
                    help="front-door response cache keyed by (tenant, "
                         "query bytes, model generation) (default "
                         "PIO_ROUTER_CACHE or off)")
    sp.add_argument("--cache-mb", type=int, default=0,
                    help="response-cache budget in MB (0 = "
                         "PIO_ROUTER_CACHE_MB or 16)")
    sp.add_argument("--cache-ttl-ms", type=float, default=0.0,
                    help="response-cache entry TTL in ms (0 = "
                         "PIO_ROUTER_CACHE_TTL_MS or 5000)")
    sp.add_argument("--autopilot", action="store_true",
                    help="run the SLO-driven fleet control loop in this "
                         "router process (workflow/autopilot.py)")
    sp.add_argument("--autopilot-dry-run", action="store_true",
                    help="the embedded autopilot journals would-have "
                         "actions without acting")
    sp.add_argument("--replica-cmd", default="",
                    help="command template with a {port} placeholder the "
                         "autopilot starts local replicas from; empty "
                         "turns replica control off")
    sp.add_argument("--autotrain", action="store_true",
                    help="run the continuous-training loop in this router "
                         "process: retrains as pio train subprocesses, "
                         "validated candidates published through the "
                         "zero-drop /reload barrier (workflow/autotrain.py)")
    sp.add_argument("--autotrain-dry-run", action="store_true",
                    help="the embedded autotrain journals would-have "
                         "retrain decisions without training")
    sp.add_argument("--engine-dir", default=".",
                    help="engine directory the embedded autotrain reads "
                         "params from and retrains")
    sp.add_argument("--variant", default="engine.json")
    sp.add_argument("--train-cmd", default="",
                    help="the embedded autotrain's retrain command "
                         "(default: the port's pio train over "
                         "--engine-dir / --variant)")
    telemetry_flags(sp)

    sp = sub.add_parser(
        "autopilot",
        help="SLO-driven control loop over a running router: elastic "
             "replicas, the degradation ladder, latency quarantine, one "
             "profile capture per burn episode (workflow/autopilot.py)")
    sp.add_argument("--router", required=True,
                    help="router base URL, e.g. http://host:8100")
    sp.add_argument("--dry-run", action="store_true",
                    help="journal would-have actions without acting")
    sp.add_argument("--replica-cmd", default="",
                    help="command template with a {port} placeholder to "
                         "start local replicas from; empty turns replica "
                         "control off")
    telemetry_flags(sp)

    sp = sub.add_parser(
        "autotrain",
        help="continuous-training loop over a running deploy server or "
             "router: drift / cursor-lag / volume / staleness triggers, "
             "pio train subprocesses with one crash-resume, score and "
             "ranking-parity gates, the /reload publish "
             "(workflow/autotrain.py)")
    sp.add_argument("--server", required=True,
                    help="deploy server or router base URL, e.g. "
                         "http://host:8000")
    engine_flags(sp)
    sp.add_argument("--dry-run", action="store_true",
                    help="journal would-have retrain decisions without "
                         "training")
    sp.add_argument("--train-cmd", default="",
                    help="retrain command run per cycle (default: the "
                         "port's pio train over --engine-dir / --variant)")
    telemetry_flags(sp)

    sp = sub.add_parser("undeploy", help="stop a deployed engine server")
    sp.add_argument("--ip", default="localhost")
    sp.add_argument("--port", type=int, default=8000)

    sp = sub.add_parser(
        "profile",
        help="capture a bounded profile from a running daemon (POST "
             "/debug/profile; a Chrome trace on the server; exit 0 "
             "non-empty / 1 failed / 2 unreachable)")
    sp.add_argument("url", nargs="?", default="",
                    help="daemon base URL (default http://<ip>:<port>)")
    sp.add_argument("--ip", default="localhost")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--ms", type=int, default=2000,
                    help="capture length in ms (server clamps to its "
                         "PIO_PROFILE_MAX_MS, default 10000)")
    sp.add_argument("-o", "--out", default="",
                    help="server-side subdirectory (under the server's "
                         "PIO_PROFILE_DIR) for the artifact; paths "
                         "escaping the base are refused (400)")
    sp.add_argument("--timeout", type=float, default=5.0,
                    help="per-request timeout in seconds")

    sp = sub.add_parser(
        "doctor",
        help="one-screen health verdict for a running daemon "
             "(scrapes /healthz, /metrics, /traces.json, "
             "/debug/device.json; exit 0 green / 1 red / 2 unreachable)")
    sp.add_argument("url", nargs="?", default="",
                    help="daemon base URL (default http://<ip>:<port>)")
    sp.add_argument("--ip", default="localhost")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--targets", default="",
                    help="comma-separated fleet base URLs (router + "
                         "replicas + storage): run the verdict over "
                         "every member, exit with the worst code")
    sp.add_argument("--timeout", type=float, default=5.0,
                    help="per-scrape timeout in seconds")

    sp = sub.add_parser(
        "trace",
        help="assemble one trace id across a daemon fleet into a "
             "single waterfall tree (fans out to every target's "
             "/traces.json?trace_id=, joins spans with clock-skew "
             "correction; exit 0 assembled / 1 not found / 2 "
             "unreachable)")
    sp.add_argument("trace_id", help="the 16-hex trace id (from "
                    "/debug/slow.json, a /metrics exemplar, a journal "
                    "event, or an X-PIO-Trace header)")
    sp.add_argument("--targets", required=True,
                    help="comma-separated daemon base URLs (query, "
                         "storage, event servers)")
    sp.add_argument("--timeout", type=float, default=5.0,
                    help="per-target timeout in seconds")

    sp = sub.add_parser(
        "events",
        help="merge-tail the operational journals "
             "(/debug/events.json) of a daemon fleet by timestamp "
             "(exit 0 / 2 when every target is unreachable)")
    sp.add_argument("--targets", required=True,
                    help="comma-separated daemon base URLs")
    sp.add_argument("--since-seq", type=int, default=0,
                    help="only events with seq beyond this cursor "
                         "(per target; default 0 = everything buffered)")
    sp.add_argument("--level", default="",
                    help="minimum severity: info (default) / warn / red")
    sp.add_argument("--category", default="",
                    help="narrow to one journal category")
    sp.add_argument("--follow", action="store_true",
                    help="keep polling for new events (Ctrl-C to stop)")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="--follow poll interval in seconds")
    sp.add_argument("--timeout", type=float, default=5.0,
                    help="per-target timeout in seconds")

    sp = sub.add_parser(
        "monitor",
        help="one-screen auto-refreshing fleet view: QPS, p99, error "
             "rate and SLO burn per target from each daemon's metrics "
             "history rings (/debug/history.json; exit 0 / 2 when "
             "every target is unreachable)")
    sp.add_argument("--targets", default="",
                    help="comma-separated daemon base URLs (router + "
                         "replicas + storage)")
    sp.add_argument("--once", action="store_true",
                    help="print one frame and exit (scripting)")
    sp.add_argument("--interval", type=float, default=5.0,
                    help="refresh interval in seconds")
    sp.add_argument("--record", default="",
                    help="append every frame's raw fetches to FILE as "
                         "JSON lines (the durable path out of the "
                         "bounded per-process rings)")
    sp.add_argument("--replay", default="",
                    help="re-render a --record file frame by frame "
                         "without touching the network")
    sp.add_argument("--timeout", type=float, default=5.0,
                    help="per-target timeout in seconds")

    sp = sub.add_parser(
        "incident",
        help="assemble one ordered incident timeline from a fleet: "
             "journal events + metric change-points (history rings) + "
             "slow exemplars + referenced traces, clock-skew "
             "corrected (exit 0 clean / 1 evidence found / 2 "
             "unreachable)")
    sp.add_argument("--targets", required=True,
                    help="comma-separated daemon base URLs")
    sp.add_argument("--window", default="10m",
                    help="lookback window, e.g. 10m / 90s / 1h "
                         "(default 10m)")
    sp.add_argument("--trace", default="",
                    help="seed the assembly with this trace id "
                         "(otherwise traces referenced by journal "
                         "events / slow exemplars are fetched)")
    sp.add_argument("--timeout", type=float, default=5.0,
                    help="per-target timeout in seconds")

    sp = sub.add_parser(
        "lint",
        help="static analysis of the port (tools/analyze; exit 0 clean "
             "/ 1 findings / 2 internal error)")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable result on stdout")
    sp.add_argument("--update-baseline", action="store_true",
                    help="accept the current findings into the "
                         "suppression baseline (predictionio_tpu_torch/"
                         "tools/analyze/lint_baseline.json)")
    sp.add_argument("--list", dest="list_passes", action="store_true",
                    help="list passes and rules, run nothing")
    sp.add_argument("--root", default="",
                    help="repo root (default: autodetected)")
    sp.add_argument("--baseline", default="",
                    help="baseline path (default predictionio_tpu_torch/"
                         "tools/analyze/lint_baseline.json)")

    sp = sub.add_parser("storageserver",
                        help="serve this node's storage to remote clients")
    sp.add_argument("--ip", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=7072)
    sp.add_argument("--key", default="",
                    help="shared secret clients must send "
                         "(X-PIO-Storage-Key; or set "
                         "PIO_STORAGE_SERVER_KEY)")
    telemetry_flags(sp)

    sp = sub.add_parser("eventserver", help="start the event server")
    sp.add_argument("--ip", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=7070)
    sp.add_argument("--stats", action="store_true")
    telemetry_flags(sp)

    sp = sub.add_parser("dashboard", help="start the evaluation dashboard")
    sp.add_argument("--ip", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=9000)
    sp.add_argument("--key", default="",
                    help="require this server key (or set PIO_SERVER_KEY)")

    sp = sub.add_parser("adminserver", help="start the admin API server")
    sp.add_argument("--ip", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7071)
    sp.add_argument("--key", default="",
                    help="require this server key (or set PIO_SERVER_KEY)")

    sp = sub.add_parser("app", help="manage apps")
    asub = sp.add_subparsers(dest="app_command", required=True)
    a = asub.add_parser("new")
    a.add_argument("name")
    a.add_argument("--id", type=int, default=None)
    a.add_argument("--description", default=None)
    a.add_argument("--access-key", default=None)
    asub.add_parser("list")
    a = asub.add_parser("show")
    a.add_argument("name")
    a = asub.add_parser("delete")
    a.add_argument("name")
    a.add_argument("-f", "--force", action="store_true")
    a = asub.add_parser("data-delete")
    a.add_argument("name")
    a.add_argument("--channel", default=None)
    a.add_argument("--all", action="store_true")
    a.add_argument("-f", "--force", action="store_true")
    a = asub.add_parser("channel-new")
    a.add_argument("name")
    a.add_argument("channel")
    a = asub.add_parser("channel-delete")
    a.add_argument("name")
    a.add_argument("channel")
    a.add_argument("-f", "--force", action="store_true")

    sp = sub.add_parser("accesskey", help="manage access keys")
    ksub = sp.add_subparsers(dest="accesskey_command", required=True)
    k = ksub.add_parser("new")
    k.add_argument("app_name")
    k.add_argument("--key", default=None)
    k.add_argument("--event", action="append", default=None,
                   help="restrict to this event name (repeatable)")
    k = ksub.add_parser("list")
    k.add_argument("app_name", nargs="?", default=None)
    k = ksub.add_parser("delete")
    k.add_argument("key")

    sp = sub.add_parser("import", help="import events from a JSON-lines file")
    sp.add_argument("--appid", type=int, required=True)
    sp.add_argument("--channel", default=None)
    sp.add_argument("--input", required=True)

    sp = sub.add_parser("export", help="export events to a JSON-lines file")
    sp.add_argument("--appid", type=int, required=True)
    sp.add_argument("--channel", default=None)
    sp.add_argument("--output", required=True)

    sp = sub.add_parser("run", help="run an arbitrary entry point")
    sp.add_argument("main_class")
    sp.add_argument("args", nargs="*")
    sp.add_argument("--engine-dir", default=".")

    sub.add_parser("shell", help="interactive shell with Storage "
                   "preloaded (pio-shell)")

    sp = sub.add_parser("template", help="engine template info")
    tsub = sp.add_subparsers(dest="template_command")
    tsub.add_parser("list")
    t = tsub.add_parser("get")
    t.add_argument("name", nargs="?")

    sp = sub.add_parser(
        "unregister",
        help="unregister an engine (no-op; Console.scala:170 parity)")
    sp.add_argument("--engine-dir", default=".")
    sub.add_parser("upgrade", help="no longer supported")
    return p


_DISPATCH = {
    "build": cmd_build,
    "train": cmd_train,
    "eval": cmd_eval,
    "deploy": cmd_deploy,
    "foldin": cmd_foldin,
    "router": cmd_router,
    "autopilot": cmd_autopilot,
    "autotrain": cmd_autotrain,
    "undeploy": cmd_undeploy,
    "profile": cmd_profile,
    "eventserver": cmd_eventserver,
    "dashboard": cmd_dashboard,
    "adminserver": cmd_adminserver,
    "storageserver": cmd_storageserver,
    "doctor": cmd_doctor,
    "trace": cmd_trace,
    "events": cmd_events,
    "monitor": cmd_monitor,
    "incident": cmd_incident,
    "lint": cmd_lint,
    "status": cmd_status,
    "app": cmd_app,
    "accesskey": cmd_accesskey,
    "import": cmd_import,
    "export": cmd_export,
    "run": cmd_run,
    "shell": cmd_shell,
    "template": cmd_template,
    "unregister": cmd_unregister,
    "upgrade": cmd_upgrade,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.INFO)
    if args.command is None or args.command == "version":
        print(__version__)
        return 0
    try:
        # a variable asking for an unported feature fails before any work
        if args.command in knobs.ALL_VERBS:
            knobs.refuse_unported(args.command)
        return _DISPATCH[args.command](args)
    except (CommandError, FileNotFoundError, ValueError) as e:
        # operational failures (no COMPLETED instance for deploy, bad
        # params, incompatible checkpoints, missing files) print one line
        # and exit 1; -v keeps the traceback reachable
        logger.debug("command failed", exc_info=True)
        _error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
