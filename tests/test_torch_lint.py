"""`pio lint` for the port (``predictionio_tpu_torch/tools/analyze``)
against the reference's.

1. **Parity**: the same seeded-defect sources go through each pass the
   port shares with the reference (timing, lock order, debug surface,
   env / metric / journal declarations, the pragma rules) in both
   packages, and the ``(rule, line, detail)`` sets are equal; each of
   the reference's jit-purity and aot-registration fixtures has a
   registered-entry fixture in torch terms that fires the same rules.
2. **The torch form of host-sync**: torch sources with the findings the
   rules should give written out.
3. **The runtime monitor**: the same acquisition scripts give the same
   edges and inversions in both packages, and a CPU deploy with the
   monitor around the port's serving locks under concurrent queries
   gives none.
4. **The runner**: the baseline contract, ``--update-baseline``, exit 2
   on a parse failure, the CLI verb, and the real tree linting clean.
5. **The warm-up registry at run time**: every registered serving entry
   that a deploy kind's queries call (and, with fold-in, its tick's
   solve) is called by that kind's warm-up, run with ``prebuild`` on the
   CPU.
"""

import ast
import json
import os
import threading

import pytest

from predictionio_tpu.tools.analyze import runtime as ref_runtime
from predictionio_tpu.tools.analyze import walker as ref_walker
from predictionio_tpu.tools.analyze.passes import (
    aot_registration as ref_aot, debug_surface as ref_debug,
    declarations as ref_decl, jit_purity as ref_jit,
    lock_order as ref_lock, timing as ref_timing,
)
from predictionio_tpu_torch.common import telemetry
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.tools.analyze import runner, runtime, walker
from predictionio_tpu_torch.tools.analyze.findings import (
    Baseline, Finding, stale_findings,
)
from predictionio_tpu_torch.tools.analyze.passes import (
    all_passes, aot_registration, debug_surface, declarations, host_sync,
    jit_purity, lock_order, timing,
)

ROOT = walker.repo_root()
PASSES = ["timing", "host-sync", "jit-purity", "lock-order",
          "declarations", "aot-registration", "debug-surface"]


def _ref_mod(src, rel):
    rel = f"predictionio_tpu/{rel}"
    return ref_walker.Module(path=os.path.join(ROOT, rel), rel=rel,
                             source=src, tree=ast.parse(src))


def _mod(src, rel="fake/mod.py"):
    rel = f"predictionio_tpu_torch/{rel}"
    return walker.Module(path=os.path.join(ROOT, rel), rel=rel,
                         source=src, tree=ast.parse(src))


def _keys(findings):
    """(rule, line, detail) with each package's name folded out."""
    return {(f.rule, f.line, f.detail.replace("predictionio_tpu_torch/",
                                              "PKG/")
             .replace("predictionio_tpu/", "PKG/")) for f in findings}


# ---------------------------------------------------------------------------
# 1. parity with the reference's passes on seeded defects
# ---------------------------------------------------------------------------

TIMING = {
    "block_until_ready_clock": (
        "import time\nimport jax\n"
        "def timed(x):\n"
        "    t0 = time.perf_counter()\n"
        "    y = x + 1\n"
        "    jax.block_until_ready(y)\n"
        "    return time.perf_counter() - t0\n"),
    "wall_clock_aliases": (
        "import time as t\nx = t.time()\nfrom time import time\n"
        "y = time()\n"),
    "perf_counter": "import time\nx = time.perf_counter()\n",
    "pragma_opt_out": (
        "import jax\n# dispatch barrier, nothing timed behind it\n"
        "jax.block_until_ready(0)  "
        "# pio-lint: allow=timing-block-until-ready\n"),
    "module_pragma": (
        "# pio-lint: module-allow=timing-block-until-ready\n"
        "import jax\njax.block_until_ready(0)\nx.block_until_ready()\n"),
    "pragma_same_line": (
        "import time as t\n"
        "x = t.time()  # pio-lint: allow=timing-wall-clock\n"),
    "pragma_line_above": (
        "import time as t\n# pio-lint: allow=timing-wall-clock\n"
        "x = t.time()\n"),
    "pragma_two_lines_above": (
        "import time as t\n# pio-lint: allow=timing-wall-clock\n\n"
        "x = t.time()\n"),
    "pragma_other_rule": (
        "import time as t\n"
        "x = t.time()  # pio-lint: allow=gather-clip\n"),
}

LOCKS = {
    "inversion": (
        "import threading\na_lock = threading.Lock()\n"
        "b_lock = threading.Lock()\n"
        "def path_one():\n    with a_lock:\n        with b_lock:\n"
        "            pass\n"
        "def path_two():\n    with b_lock:\n        with a_lock:\n"
        "            pass\n"),
    "consistent": (
        "import threading\na_lock = threading.Lock()\n"
        "b_lock = threading.Lock()\n"
        "def path_one():\n    with a_lock:\n        with b_lock:\n"
        "            pass\n"
        "def path_two():\n    with a_lock, b_lock:\n            pass\n"),
    "classes": (
        "class A:\n    def f(self):\n        with self._lock:\n"
        "            with self._cond:\n                pass\n"
        "class B:\n    def g(self):\n        with self._cond:\n"
        "            with self._lock:\n                pass\n"),
    "one_class_both_orders": (
        "class C:\n    def f(self):\n        with self._lock:\n"
        "            with self._cond.acquire():\n                pass\n"
        "    def g(self):\n        with self._cond:\n"
        "            with self._lock:\n                pass\n"),
    "pragma_on_def": (
        "def f():\n    with a_lock:\n        with b_mutex:\n"
        "            pass\n"
        "def g():  # pio-lint: allow=lock-order-inversion\n"
        "    with b_mutex:\n        with a_lock:\n            pass\n"),
}

DECLARATIONS = {
    "undeclared_env": (
        "import os\nx = os.environ.get('PIO_NOT_A_REAL_KNOB_XYZ', '')\n"),
    "env_shapes": (
        "import os\na = os.getenv('PIO_BOGUS_A')\n"
        "b = os.environ['PIO_BOGUS_B']\n"
        "c = self._env.get('PIO_BOGUS_C')\n"
        "d = _env_float('PIO_BOGUS_D', 1.0)\n"
        "e = os.environ.get(f'PIO_SLO_{which}')\n"
        "f = os.environ.get(f'PIO_NOPE_{which}')\n"
        "g = os.environ.get('PIO_STORAGE_SOURCES_X_TYPE')\n"
        "h = os.environ.pop('PIO_FS_BASEDIR')\n"
        "i = os.environ.get('PIO_BOGUS_I')  "
        "# pio-lint: allow=env-undeclared\n"),
    "undeclared_metric": (
        "from predictionio_tpu.common import telemetry\n"
        "c = telemetry.registry.counter('pio_ghost_series_total', 'x')\n"
        "g = reg.gauge('pio_batcher_queue_depth', 'x')\n"
        "h = reg.histogram('pio_' + name, 'x')\n"),
    "journal_categories": (
        "from predictionio_tpu.common import journal\n"
        "journal.emit('not_a_real_category_xyz', 'boom')\n"
        "journal.emit(category='also_bogus_xyz', message='x')\n"
        "journal.emit('wal', 'repaired', level=journal.WARN)\n"
        "journal.emit(cat, 'dynamic')\n"
        "other.emit('bogus', 'not the journal')\n"),
    "tenant": (
        "import os\nfrom predictionio_tpu.common import journal, telemetry\n"
        "r = os.environ.get('PIO_TENANT_RATE', '')\n"
        "h = os.environ.get('PIO_TENANT_HBM_HARD_CAP_MB', '')\n"
        "c = telemetry.registry().counter(\n"
        "    'pio_tenant_requests_total', 'x',\n"
        "    labelnames=('tenant', 'outcome'))\n"
        "d = telemetry.registry().counter(\n"
        "    'pio_tenant_evictions_total', 'x')\n"
        "journal.emit('tenant', 'over budget', level=journal.WARN)\n"),
    "history_and_router": (
        "import os\n"
        "t = os.environ.get('PIO_HISTORY_TICK_S', '5')\n"
        "x = os.environ.get('PIO_HISTORY_BOGUS_KNOB', '')\n"
        "y = os.environ.get('PIO_ROUTER_CACHE_GHOST_KNOB', '')\n"
        "reg.counter('pio_router_cache_hits_total', 'x')\n"
        "reg.counter('pio_router_cache_ghost_total', 'x')\n"
        "reg.gauge('pio_history_series', 'x')\n"),
    "autopilot": (
        "import os\n"
        "a = os.environ.get('PIO_AUTOPILOT_COOLDOWN_S', '30')\n"
        "reg.counter('pio_autopilot_actions_total', 'x')\n"
        "reg.counter('pio_autopilot_bogus_total', 'x')\n"
        "journal.emit('autopilot', 'shed widened')\n"
        "journal.emit('fold_in_typo_xyz', 'headroom gone')\n"),
}


@pytest.mark.parametrize("name", sorted(TIMING))
def test_timing_pass_matches_the_reference(name):
    src = TIMING[name]
    got = _keys(timing.run([_mod(src)]))
    assert got == _keys(ref_timing.run([_ref_mod(src, "fake/mod.py")]))
    if name in ("block_until_ready_clock", "wall_clock_aliases",
                "pragma_two_lines_above", "pragma_other_rule"):
        assert got                       # the seeded defect is found


@pytest.mark.parametrize("name", sorted(LOCKS))
def test_lock_order_pass_matches_the_reference(name):
    src = LOCKS[name]
    got = lock_order.run([_mod(src)])
    assert _keys(got) == _keys(ref_lock.run([_ref_mod(src, "fake/mod.py")]))
    assert sorted(lock_order.build_graph([_mod(src)])) == sorted(
        tuple(x.replace("predictionio_tpu/", "predictionio_tpu_torch/")
              for x in edge)
        for edge in ref_lock.build_graph([_ref_mod(src, "fake/mod.py")]))
    assert bool(got) == (name in ("inversion", "one_class_both_orders"))


@pytest.mark.parametrize("name", sorted(DECLARATIONS))
def test_declarations_pass_matches_the_reference(name):
    src = DECLARATIONS[name]
    got = declarations.run([_mod(src)], readme_text="")
    want = ref_decl.run([_ref_mod(src, "fake/mod.py")], readme_text="")
    assert _keys(got) == _keys(want)
    assert got                           # every source seeds a defect


DEBUG = {
    "private_path": "PATH = '/debug/private.json'\n",
    "query_form": "PATH = '/debug/slow.json?limit=3'\n",
    "bare_prefix": "if p.startswith('/debug/'):\n    pass\n",
    "pragma": "P = '/debug/x.json'  # pio-lint: allow=debug-path-unshared\n",
    "routed": ("from common import telemetry\n"
               "telemetry.handle_route('GET', '/debug/nope.json')\n"),
}


@pytest.mark.parametrize("name", sorted(DEBUG))
def test_debug_surface_pass_matches_the_reference(name):
    shared = "DEBUG_PATHS = ('/debug/slow.json', '/debug/device.json')\n"
    src = DEBUG[name]
    got = debug_surface.run([
        _mod(shared, "common/telemetry.py"),
        _mod(src, "data/api/service.py")])
    want = ref_debug.run([
        _ref_mod(shared, "common/telemetry.py"),
        _ref_mod(src, "data/api/service.py")])
    assert _keys(got) == _keys(want)
    # the event server's module is a daemon: one that never routes
    # through telemetry.handle_route is a finding in both packages
    assert any(f.rule == "daemon-no-handle-route"
               for f in got) == (name != "routed")


def test_debug_surface_abstains_without_the_shared_paths():
    src = "PATH = '/debug/private.json'\n"
    assert debug_surface.run([_mod(src)]) == []
    assert ref_debug.run([_ref_mod(src, "fake/mod.py")]) == []


def test_the_daemons_are_the_references_six():
    assert [m.replace("predictionio_tpu_torch/", "") for m in
            debug_surface.DAEMON_MODULES] == [
        m.replace("predictionio_tpu/", "")
        for m in ref_debug.DAEMON_MODULES]


def test_the_pass_table_is_the_references_seven():
    from predictionio_tpu.tools.analyze.passes import all_passes as ref_all
    ref_table = {p.name: p.rules for p in ref_all()}
    assert [p.name for p in all_passes()] == PASSES == list(ref_table)
    for p in all_passes():
        assert p.rules == ref_table[p.name], p.name


def _rules(findings):
    return sorted({f.rule for f in findings})


REG = "from predictionio_tpu_torch.serving.aot import register_entry\n"

#: the reference's jit-purity fixtures (tests/test_lint.py) beside their
#: torch form: a body registered with the warm-up instead of a jitted one
JIT = {
    "wall_clock": (
        "import time\nimport jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x + time.time()\n",
        "import time\n" + REG +
        "def f(x):\n"
        "    return x + time.time()\n"
        "register_entry('f', f)\n"),
    "rng_io_global_mutation": (
        "import random\nimport jax\n"
        "STATE = {}\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    global STATE\n"
        "    print(x)\n"
        "    return x * random.random()\n",
        "import random\n" + REG +
        "STATE = {}\n"
        "def f(x):\n"
        "    global STATE\n"
        "    print(x)\n"
        "    return x * random.random()\n"
        "register_entry('f', f)\n"),
    "explicit_key_is_legal": (
        "import jax\n"
        "@jax.jit\n"
        "def f(key, x):\n"
        "    return x + jax.random.normal(key, x.shape)\n",
        "import torch\n" + REG +
        "def f(gen, x):\n"
        "    return x + torch.randn(x.shape, generator=gen)\n"
        "register_entry('f', f)\n"),
    "unjitted_is_not_checked": (
        "import time\nimport jax\n"
        "def eager(x):\n"
        "    return x + time.time()\n",
        "import time\n" + REG +
        "def eager(x):\n"
        "    return x + time.time()\n"),
}


@pytest.mark.parametrize("name", sorted(JIT))
def test_jit_purity_fires_as_the_references_on_registered_entries(name):
    ref_src, src = JIT[name]
    got = jit_purity.run([_mod(src)])
    want = ref_jit.run([_ref_mod(ref_src, "fake/mod.py")])
    assert _rules(got) == _rules(want)
    assert bool(got) == (name in ("wall_clock", "rng_io_global_mutation"))


#: the torch-only shapes: the process-global generator, env reads, a
#: registration resolved into another module, the pragma
JIT_TORCH = {
    "global_generator": (
        "import torch\n" + REG +
        "def f(x):\n"
        "    a = torch.randn(x.shape)\n"                        # 4
        "    x.uniform_()\n"                                    # 5
        "    g = torch.Generator()\n"
        "    return a + torch.rand(3, generator=g)\n"
        "register_entry('f', f)\n",
        {("jit-nondeterminism", 4), ("jit-nondeterminism", 5)}),
    "env_and_logging": (
        "import logging, os\n" + REG +
        "logger = logging.getLogger('x')\n"
        "def f(x):\n"
        "    t = os.environ.get('PIO_SERVE_FUSED_TILE')\n"      # 5
        "    u = os.environ['PIO_SERVE_FUSED']\n"               # 6
        "    logger.info('serving %s', t)\n"                    # 7
        "    return x, u\n"
        "def hoisted():\n"
        "    return os.environ.get('PIO_SERVE_FUSED_TILE')\n"
        "register_entry('f', f)\n",
        {("jit-io", 5), ("jit-io", 6), ("jit-io", 7)}),
    "pragma": (
        "import time\n" + REG +
        "def f(x):\n"
        "    # a deadline, never part of the answer\n"
        "    # pio-lint: allow=jit-wall-clock\n"
        "    t = time.monotonic()\n"
        "    return x, time.perf_counter() - t\n"               # 7
        "register_entry('f', f)\n",
        {("jit-wall-clock", 7)}),
}


@pytest.mark.parametrize("name", sorted(JIT_TORCH))
def test_jit_purity_in_torch_terms(name):
    src, want = JIT_TORCH[name]
    assert {(f.rule, f.line) for f in jit_purity.run([_mod(src)])} == want


def test_jit_purity_follows_a_registration_into_another_module():
    """``register_entry("n", kern.f)`` holds ``ops/kern.py``'s ``f``, as
    the reference's register_jit resolution does."""
    kern = ("import time\n"
            "def f(x):\n"
            "    return x + time.time()\n"
            "def g(x):\n"
            "    return x + time.time()\n")
    reg = ("from predictionio_tpu_torch.ops import kern\n" + REG +
           "register_entry('f', kern.f)\n")
    got = jit_purity.run([_mod(kern, "ops/kern.py"),
                          _mod(reg, "serving/aot.py")])
    assert [(f.rule, f.path, f.line) for f in got] == [
        ("jit-wall-clock", "predictionio_tpu_torch/ops/kern.py", 3)]
    ref_kern = kern.replace("def f", "@jax.jit\ndef f", 1)
    ref_got = ref_jit.run([_ref_mod("import jax\n" + ref_kern,
                                    "ops/kern.py")])
    assert _rules(ref_got) == _rules(got)


LAUNCH = "from predictionio_tpu_torch.ops import _kernels\n"

#: the reference's aot-registration fixtures (tests/test_lint.py) beside
#: their torch form (path, reference source, torch source): a def that
#: launches a hand kernel instead of a jitted one
AOT = {
    "unregistered_serving_entry": (
        "serving/newmod.py",
        "import jax\n"
        "@jax.jit\n"
        "def brand_new_kernel(x):\n"
        "    return x\n",
        LAUNCH +
        "def brand_new_kernel(x):\n"
        "    return _kernels.load('brand_new').pio_brand_new(x)\n"),
    "scope_is_structural": (
        "parallel/newdist.py",
        "import jax\n"
        "from predictionio_tpu.serving.aot import register_jit\n"
        "@jax.jit\n"
        "def registered(x):\n"
        "    return x\n"
        "@jax.jit\n"
        "def forgotten(x):\n"
        "    return x\n"
        "register_jit('registered', registered)\n",
        LAUNCH + REG +
        "def _library():\n"
        "    return _kernels.load('newdist')\n"
        "def _launch(x):\n"
        "    return _library().pio_run(x)\n"
        "def registered(x):\n"
        "    return _launch(x)\n"
        "def forgotten(x):\n"
        "    return _launch(x)\n"
        "register_entry('registered', registered)\n"),
    "forgotten_quant_sibling": (
        "ops/quant_v2.py",
        "import jax\n"
        "from predictionio_tpu.serving.aot import register_jit\n"
        "@jax.jit\n"
        "def topk_quant(x):\n"
        "    return x\n"
        "@jax.jit\n"
        "def topk_quant_fused(x):\n"
        "    return x\n"
        "register_jit('topk_quant', topk_quant)\n",
        "from predictionio_tpu_torch.ops import _kernels as kern\n" + REG +
        "def topk_quant(x):\n"
        "    return x\n"
        "def topk_quant_fused(x):\n"
        "    return kern.load('topk_fused').pio_topk(x)\n"
        "register_entry('topk_quant', topk_quant)\n"),
    "outside_the_scope": (
        "ops/offline.py",
        "import jax\n"
        "@jax.jit\n"
        "def batch_kernel(x):\n"
        "    return x\n",
        LAUNCH +
        "def batch_kernel(x):\n"
        "    return _kernels.load('offline').pio_run(x)\n"),
    "pragma": (
        "serving/newmod.py",
        "import jax\n"
        "@jax.jit\n"
        "def tool(x):  # pio-lint: allow=aot-unregistered-jit\n"
        "    return x\n",
        LAUNCH +
        "def tool(x):  # pio-lint: allow=aot-unregistered-jit\n"
        "    return _kernels.load('tool').pio_run(x)\n"),
}


@pytest.mark.parametrize("name", sorted(AOT))
def test_aot_registration_fires_as_the_references_on_device_entries(name):
    rel, ref_src, src = AOT[name]
    got = aot_registration.run([_mod(src, rel)])
    want = ref_aot.run([_ref_mod(ref_src, rel)])
    assert [(f.rule, f.detail) for f in got] == [
        (f.rule, f.detail) for f in want]
    assert bool(got) == (name not in ("outside_the_scope", "pragma"))


def test_a_public_def_reaching_another_modules_entry_is_not_one():
    """A def that launches only through another module's public entry is
    held where that entry is defined, not here; private launchers make
    a public caller an entry however deep they nest."""
    src = (LAUNCH + REG +
           "from predictionio_tpu_torch.ops import solve\n"
           "def _library():\n"
           "    return _kernels.load('x')\n"
           "def _inner(x):\n"
           "    return _library().pio_x(x)\n"
           "def _outer(x):\n"
           "    return _inner(x)\n"
           "def through_private(x):\n"
           "    return _outer(x)\n"
           "def through_public(A, b, r):\n"
           "    return solve.solve_factors(A, b, r)\n"
           "register_entry('through_public', through_public)\n")
    mod = _mod(src, "serving/mix.py")
    assert [fn.name for fn in aot_registration.device_entries(mod)] == [
        "through_private"]
    assert [f.detail for f in aot_registration.run([mod])] == [
        "through_private"]


def test_the_scope_covers_the_serving_path_modules():
    scope = {m.rel for m in aot_registration.serving_scope(
        walker.discover(ROOT))}
    for rel in ("ops/topk.py", "ops/topk_fused.py", "ops/quant.py",
                "ops/solve.py", "ops/als.py", "parallel/serve_dist.py",
                "realtime/foldin.py", "serving/aot.py",
                "serving/batcher.py"):
        assert f"predictionio_tpu_torch/{rel}" in scope, rel


def test_the_ports_kernel_entries_are_found_and_registered():
    """The static pass sees B1, B2 and kernel A's wrappers as device
    entries, and the real tree less one registration fires on it."""
    modules = walker.discover(ROOT)
    by_rel = {m.rel: m for m in modules}
    fused = by_rel["predictionio_tpu_torch/ops/topk_fused.py"]
    entries = {fn.name for m in aot_registration.serving_scope(modules)
               for fn in aot_registration.device_entries(m)}
    assert entries == {"score_mask_topk_candidates", "merge_candidates",
                       "solve_factors"}
    assert entries <= aot_registration.registered_fn_names(modules)
    assert aot_registration.run(modules) == []
    line = '        "merge_candidates", merge_candidates, kind="serving",'
    assert line in fused.source
    cut = fused.source.replace(line, '        "merge_candidates", None,')
    broken = [m if m is not fused else _mod(cut, "ops/topk_fused.py")
              for m in modules]
    assert [f.detail for f in aot_registration.run(broken)] == [
        "merge_candidates"]


def test_the_registered_bodies_resolve_across_modules():
    regs = {(m.rel, fn.name)
            for m, fn in walker.registered_entry_defs(walker.discover(ROOT))}
    for rel, name in (("ops/topk.py", "topk_for_users"),
                      ("ops/topk_fused.py", "topk_for_users_quant_fused"),
                      ("ops/solve.py", "solve_factors"),
                      ("ops/als.py", "train_explicit"),
                      ("realtime/foldin.py", "foldin_solve"),
                      ("parallel/serve_dist.py",
                       "topk_for_users_sharded_quant")):
        assert (f"predictionio_tpu_torch/{rel}", name) in regs


# ---------------------------------------------------------------------------
# 2. host-sync in torch terms
# ---------------------------------------------------------------------------

HOST_SYNC = {
    "implicit_on_torch_values": (
        "import torch\n"
        "def serve(q):\n"
        "    scores = torch.mm(q, q.T)\n"                        # 3
        "    best = scores.max(dim=1).values\n"                  # 4
        "    n = int(scores.shape[0]) + len(best)\n"             # 5
        "    print(best)\n"                                      # 6
        "    ok = bool(torch.isfinite(q).all())\n"               # 7
        "    fine = bool(torch.isfinite(q).all().cpu())\n"       # 8
        "    host = best.to('cpu').tolist()\n"                   # 9
        "    return float(scores.max()), best.tolist(), n\n",    # 10
        {("hostsync-implicit", 6), ("hostsync-implicit", 7),
         ("hostsync-implicit", 10)}),
    "host_objects_are_not_syncs": (
        "import numpy as np\nimport torch\n"
        "def f(x):\n"
        "    n = int(torch.cuda.device_count())\n"
        "    r = int(torch.distributed.get_rank())\n"
        "    eps = float(torch.finfo(torch.float32).eps)\n"
        "    a = np.asarray(x)\n"
        "    return float(x.sum())\n",
        set()),
    "module_level_and_numpy": (
        "import numpy as np\nimport torch\n"
        "W = torch.zeros(4)\n"
        "V = W + 1\n"
        "H = np.asarray(V)\n"
        "S = np.asarray(V.cpu())\n"
        "def g(W):\n"
        "    return float(W)\n",
        {("hostsync-implicit", 5)}),
    "pragma": (
        "import torch\n"
        "def f():\n"
        "    x = torch.ones(2)\n"
        "    # a host tensor: nothing waits on the card\n"
        "    # pio-lint: allow=hostsync-implicit\n"
        "    a = x.item()\n"
        "    return a, x.sum().item()\n",
        {("hostsync-implicit", 7)}),
    "gathers_unbounded": (
        "import torch\n"
        "def f(table, ix, rows):\n"
        "    a = table.index_select(0, ix)\n"                   # 3
        "    b = torch.index_select(table, 0, rows.ix)\n"        # 4
        "    c = torch.gather(table, 1, ix[:, :2])\n"            # 5
        "    d = torch.take(table, index=ix.long())\n"           # 6
        "    e = table.gather(1, index=ix)\n"                    # 7
        "    return a, b, c, d, e\n",
        {("gather-clip", n) for n in (3, 4, 5, 6, 7)}),
    "gathers_bounded": (
        "import asyncio\nimport torch\n"
        "def f(table, ix, n, lo, hi):\n"
        "    \"\"\"``lo`` must be in bounds of ``table``.\"\"\"\n"
        "    a = table.index_select(0, ix.clamp(0, n - 1))\n"
        "    safe = torch.where(ix < n, ix, 0)\n"
        "    b = table.index_select(0, safe.long())\n"
        "    _, order = torch.sort(table, dim=1)\n"
        "    c = table.gather(1, order[:, :3])\n"
        "    r = torch.arange(4)\n"
        "    alias = r.to(torch.int64)\n"
        "    d = torch.take(table, alias)\n"
        "    e = table.index_select(0, lo)\n"
        "    if (ix >= n).any():\n"
        "        raise IndexError('out of range')\n"
        "    g = table.index_select(0, ix)\n"
        "    h = table.index_select(0, 0)\n"
        "    k = asyncio.gather(a, b)\n"
        "    m = table.gather()\n"
        "    return a, b, c, d, e, g, h, k, m\n",
        set()),
    "gather_pragma": (
        "import torch\n"
        "def f(table, ix):\n"
        "    # ix are vocabulary rows, which index the table\n"
        "    # pio-lint: allow=gather-clip\n"
        "    a = table.index_select(0, ix)\n"
        "    b = table.index_select(0, ix)  # pio-lint: allow=gather-clip\n"
        "    return a, b\n",
        set()),
}


@pytest.mark.parametrize("name", sorted(HOST_SYNC))
def test_host_sync_in_torch_terms(name):
    src, want = HOST_SYNC[name]
    assert {(f.rule, f.line) for f in host_sync.run([_mod(src)])} == want


def test_host_sync_module_pragmas_silence_each_rule():
    src = ("# pio-lint: module-allow=hostsync-implicit,gather-clip\n"
           + HOST_SYNC["implicit_on_torch_values"][0]
           + "def g(t, ix):\n    return t.index_select(0, ix)\n")
    assert host_sync.run([_mod(src)]) == []


# ---------------------------------------------------------------------------
# 3. the runtime lock-order monitor
# ---------------------------------------------------------------------------

def _script(mod, script):
    mon = mod.LockOrderMonitor()
    locks = {"a": threading.Lock(), "b": threading.Lock(),
             "r": threading.RLock(), "c": threading.Condition()}
    wrapped = {k: mon.wrap(v, k) for k, v in locks.items()}
    for seq in script:
        held = []
        for name in seq:
            wrapped[name].acquire()
            held.append(name)
        for name in reversed(held):
            wrapped[name].release()
    return mon


SCRIPTS = {
    "inversion": [("a", "b"), ("b", "a")],
    "consistent": [("a", "b"), ("a", "b"), ("a", "c", "b")],
    "reentrant": [("r", "r"), ("r", "a", "r")],
    "three_way": [("a", "b"), ("b", "c"), ("c", "a")],
    "condition_inside": [("c", "a"), ("a", "c")],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_runtime_monitor_matches_the_reference(name):
    mine = _script(runtime, SCRIPTS[name])
    theirs = _script(ref_runtime, SCRIPTS[name])
    assert mine.edges() == theirs.edges()
    assert mine.inversions() == theirs.inversions()
    mine.reset()
    assert mine.edges() == {} and mine.inversions() == []


def test_runtime_monitor_across_threads_and_a_wrapped_condition():
    mon = runtime.LockOrderMonitor()
    a = mon.wrap(threading.Lock(), "a")
    b = mon.wrap(threading.Lock(), "b")
    cond = mon.wrap(threading.Condition(), "cond")
    hits = []

    def worker():
        for _ in range(50):
            with a:
                with b:
                    pass

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=5)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    threads.append(threading.Thread(target=waiter))
    for t in threads:
        t.start()
    with cond:
        hits.append(1)
        cond.notify()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert mon.inversions() == []
    assert mon.edges() == {("a", "b"): 200}


@pytest.fixture
def quant_deploy(monkeypatch):
    """A quantized, fused deploy of a small seeded model on the CPU (B1
    and B2's plain versions), batching on, telemetry on."""
    import datetime as dt

    import numpy as np

    from predictionio_tpu_torch.data.storage import (
        EngineInstance, Model, Storage,
    )
    from predictionio_tpu_torch.workflow import create_server, model_io

    monkeypatch.setenv("PIO_SERVE_FUSED", "on")
    rng = np.random.default_rng(3)
    m = model_io.als_model_from_numpy(
        6, rng.normal(size=(40, 6)), rng.normal(size=(90, 6)),
        {f"u{i}": i for i in range(40)}, {f"i{i}": i for i in range(90)})
    store = Storage(env={
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"})
    now = dt.datetime.now(dt.timezone.utc)
    iid = store.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="NOT_USED",
        engine_variant="default",
        engine_factory=("predictionio_tpu.models.recommendation.engine:"
                        "RecommendationEngine"),
        data_source_params=json.dumps({"params": {"appName": "A"}}),
        algorithms_params=json.dumps([{"name": "als", "params": {
            "rank": 6}}])))
    store.get_model_data_models().insert(
        Model(iid, model_io.serialize_models([m])))
    telemetry.set_enabled(True)
    api = create_server.QueryAPI(create_server.ServerConfig(
        device="cpu", serve_quant="on", batching="on", batch_max_size=4,
        batch_max_delay_ms=5.0), storage=store)
    try:
        yield api
    finally:
        api.close()
        telemetry.set_enabled(None)


def test_no_inversion_over_a_deploy_under_concurrent_queries(quant_deploy):
    """The runtime half over the port's serving stack, as the card's
    phase 15 runs it: the batcher's condition, the registry's lock and
    every family's and child's lock wrapped after a warm query, then a
    concurrent burst."""
    api = quant_deploy
    body = json.dumps({"user": "u1", "num": 3}).encode()
    assert api.handle("POST", "/queries.json", body=body)[0] == 200
    assert api.handle("GET", "/")[1]["quant"]["fused"]
    mon = runtime.LockOrderMonitor()
    reg = telemetry.REGISTRY
    owners = [(api._batcher, "_cond", "batcher._cond"),
              (reg, "_lock", "registry._lock")]
    for fam in list(reg._families.values()):
        owners.append((fam, "_lock", f"family[{fam.name}]._lock"))
        owners += [(child, "_lock", f"family[{fam.name}].child._lock")
                   for child in list(fam._children.values())]
    real = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in owners]
    for owner, attr, name in owners:
        setattr(owner, attr, mon.wrap(getattr(owner, attr), name))
    results = [None] * 16

    def client(k):
        q = json.dumps({"user": f"u{k}", "num": 1 + k % 5}).encode()
        results[k] = api.handle("POST", "/queries.json", body=q)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
            assert not t.is_alive()
    finally:
        for owner, attr, lock in real:     # the registry is process-wide
            setattr(owner, attr, lock)
    assert all(r[0] == 200 for r in results)
    assert mon.inversions() == [], mon.edges()
    # the burst nested locks across modules: the monitor measured
    # something, not an idle graph
    assert any(a == "batcher._cond" for a, _b in mon.edges())


# ---------------------------------------------------------------------------
# 4. the runner, the baseline and the real tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_lint():
    return runner.run_lint()


def _port_py_files():
    n = 0
    for _base, dirs, files in os.walk(os.path.join(
            ROOT, "predictionio_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        n += sum(f.endswith(".py") for f in files)
    return n


def test_the_port_lints_clean(real_lint):
    d = real_lint.as_dict()
    assert d["internalErrors"] == [], d["internalErrors"]
    assert d["exit"] == 0, real_lint.render_text()
    assert d["modulesAnalyzed"] == _port_py_files() + 1
    assert d["passes"] == PASSES
    assert d["counts"] == {"findings": 0, "suppressed": 0, "stale": 0}
    json.dumps(d)


def test_the_baseline_is_the_ports_own_and_every_entry_has_a_reason():
    path = os.path.join(ROOT, "predictionio_tpu_torch", "tools", "analyze",
                        "lint_baseline.json")
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    for entry in payload["entries"]:
        assert entry["reason"] and entry["reason"] != (
            "accepted pre-existing finding"), entry["key"]


def test_the_walk_covers_the_port_and_the_smoke_not_the_tests():
    rels = {m.rel for m in walker.discover(ROOT)}
    assert "chip_smoke.py" in rels
    assert "predictionio_tpu_torch/common/declarations.py" in rels
    assert not any(r.startswith(("tests/", "predictionio_tpu/"))
                   for r in rels)


def test_baseline_suppresses_known_fails_new_and_stales_gone(tmp_path):
    known = Finding(rule="r", path="a.py", line=3, message="m", detail="t")
    moved = Finding(rule="r", path="a.py", line=47, message="m", detail="t")
    new = Finding(rule="r", path="b.py", line=9, message="m", detail="t2")
    path = str(tmp_path / "base.json")
    Baseline(path=path).write(findings=[known])
    active, suppressed, stale = Baseline.load(path).apply([moved, new])
    assert [f.key for f in active] == [new.key]
    assert [f.key for f in suppressed] == [known.key]   # line-free key
    assert stale == []
    _a, _s, stale = Baseline.load(path).apply([])
    assert stale == [known.key]
    (gone,) = stale_findings(stale, path)
    assert gone.rule == "baseline-stale" and gone.detail == known.key


def _tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


def test_update_baseline_round_trip(tmp_path, capsys):
    root = _tree(tmp_path, {"predictionio_tpu_torch/bad.py":
                            "import time\nx = time.time()\n"})
    base = str(tmp_path / "base.json")
    argv = ["--root", root, "--baseline", base]
    assert runner.main(argv) == 1
    out = capsys.readouterr().out
    assert "timing-wall-clock" in out and "bad.py:2" in out
    assert runner.main(argv + ["--update-baseline"]) == 0
    capsys.readouterr()
    assert runner.main(argv) == 0
    capsys.readouterr()
    assert runner.main(argv + ["--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["counts"] == {"findings": 0, "suppressed": 1, "stale": 0}
    (tmp_path / "predictionio_tpu_torch" / "bad.py").write_text(
        "import time\nx = time.perf_counter()\n")
    assert runner.main(argv) == 1
    assert "baseline-stale" in capsys.readouterr().out


def test_a_parse_failure_is_exit_2(tmp_path, capsys):
    root = _tree(tmp_path, {"predictionio_tpu_torch/broken.py":
                            "def f(:\n"})
    result = runner.run_lint(root=root,
                             baseline_path=str(tmp_path / "b.json"))
    assert result.exit_code == 2
    assert any("broken.py" in e for e in result.internal_errors)
    assert cli.main(["lint", "--root", root, "--baseline",
                     str(tmp_path / "b.json")]) == 2
    assert "INTERNAL ERROR" in capsys.readouterr().out


def test_an_undeclared_read_fires_against_a_copy_of_the_registry(tmp_path):
    """The pass reads the tree's own copy of the registry (here with one
    name added), not the package's, and does not abstain."""
    src = os.path.join(ROOT, "predictionio_tpu_torch", "common",
                       "declarations.py")
    with open(src, encoding="utf-8") as f:
        registry = f.read().replace(
            '    "PIO_TORCH_DEVICE":',
            '    "PIO_ONLY_IN_THE_COPY": "a name the copy declares",\n'
            '    "PIO_TORCH_DEVICE":', 1)
    root = _tree(tmp_path, {
        "predictionio_tpu_torch/common/declarations.py": registry,
        "predictionio_tpu_torch/mod.py": (
            "import os\n"
            "a = os.environ.get('PIO_ONLY_IN_THE_COPY')\n"
            "b = os.environ.get('PIO_SEEDED_UNDECLARED_XYZ')\n"),
        "README.md": "PIO_ONLY_IN_THE_COPY\n"})
    found = declarations.run(walker.discover(root))
    undeclared = [(f.line, f.detail) for f in found
                  if f.rule == "env-undeclared"]
    assert undeclared == [(3, "PIO_SEEDED_UNDECLARED_XYZ")]
    # the copy's registry judged against the tree it sits in: its names
    # are dead there and its README documents one of them
    dead = {f.detail for f in found if f.rule == "env-dead"}
    assert "PIO_FS_BASEDIR" in dead and "PIO_ONLY_IN_THE_COPY" not in dead
    undoc = {f.detail for f in found if f.rule == "env-undocumented"}
    assert "PIO_FS_BASEDIR" in undoc
    assert "PIO_ONLY_IN_THE_COPY" not in undoc


def test_a_registry_the_pass_cannot_read_is_exit_2(tmp_path):
    root = _tree(tmp_path, {
        "predictionio_tpu_torch/common/declarations.py":
            "ENV_VARS = {**{}}\nMETRICS = {}\nJOURNAL_CATEGORIES = {}\n"})
    result = runner.run_lint(root=root,
                             baseline_path=str(tmp_path / "b.json"))
    assert result.exit_code == 2
    assert any("declarations" in e for e in result.internal_errors)


def test_the_lint_verb(capsys, tmp_path):
    assert cli.main(["lint", "--list"]) == 0
    out = capsys.readouterr().out
    for p in all_passes():
        assert p.name in out and all(r in out for r in p.rules)
    root = _tree(tmp_path, {"predictionio_tpu_torch/ok.py": "x = 1\n"})
    assert cli.main(["lint", "--json", "--root", root, "--baseline",
                     str(tmp_path / "b.json")]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["modulesAnalyzed"] == 1 and d["passes"] == PASSES


# ---------------------------------------------------------------------------
# 5. the warm-up registry at run time
# ---------------------------------------------------------------------------

#: the kinds of deploy whose warm-up the registry must cover
DEPLOY_KINDS = ["fp32", "quant_fused", "quant_plain", "sharded_fp32",
                "sharded_int8", "foldin"]
FOLD_APP = "LintFoldApp"


def _serving_entries():
    """(name, module, attribute) of every registered serving entry, every
    registering module imported first (registration runs at import)."""
    import importlib
    import sys

    for mod in ("ops.quant", "ops.topk_fused", "parallel.serve_dist",
                "realtime.foldin"):
        importlib.import_module(f"predictionio_tpu_torch.{mod}")
    from predictionio_tpu_torch.serving import aot
    return [(name, sys.modules[r.fn.__module__], r.fn.__name__)
            for name, r in sorted(aot._REGISTRY.items())
            if r.kind == "serving"]


def _kind_model(kind, monkeypatch, tmp_path):
    """(algorithm, prepared model, fold-in (worker, store, app id) or
    None) of one kind, on the CPU at a small size."""
    import numpy as np

    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel,
    )
    from predictionio_tpu_torch.ops import quant
    from predictionio_tpu_torch.parallel import serve_dist
    from predictionio_tpu_torch.parallel.mesh import Mesh
    from predictionio_tpu_torch.realtime import foldin
    from predictionio_tpu_torch.workflow import model_io

    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", "1e9")
    monkeypatch.setenv("PIO_SERVE_FUSED",
                       "off" if kind == "quant_plain" else "on")
    rng = np.random.default_rng(21)
    m = model_io.als_model_from_numpy(
        6, rng.normal(size=(40, 6)), rng.normal(size=(90, 6)),
        {f"u{i}": i for i in range(40)}, {f"i{i}": i for i in range(90)})
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=6))
    if kind.startswith("sharded"):
        qf = (quant.QuantizedFactors.from_factors(m.user_factors,
                                                  m.item_factors)
              if kind == "sharded_int8" else None)
        sf = serve_dist.shard_factors(m.user_factors, m.item_factors,
                                      mesh=Mesh(["cpu"] * 2), quant=qf)
        return algo, ALSModel(
            rank=6, user_factors=m.user_factors,
            item_factors=m.item_factors, user_vocab=m.user_vocab,
            item_vocab=m.item_vocab, sharding=sf), None
    fold = None
    prep = (foldin.pad_capacity([m], 8, [algo], item_headroom=4)
            if kind == "foldin" else None)
    mode = "on" if kind.startswith("quant") else "off"
    with quant.deploy_scope(mode, device="cpu"):
        m = algo.prepare_serving(m)
    if kind == "foldin":
        storage = Storage(env={
            "PIO_STORAGE_SOURCES_M_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"})
        app_id = storage.get_meta_data_apps().insert(App(0, FOLD_APP, None))
        storage.get_events().init(app_id)
        worker = foldin.FoldinWorker(
            storage, foldin.FoldinConfig(app_name=FOLD_APP, lambda_=0.01),
            cursor_directory=str(tmp_path / "cur"), device="cpu")
        worker.bind(m, generation=1, prep=prep)
        fold = (worker, storage, app_id)
    return algo, m, fold


def _tick(worker, storage, app_id):
    """Events for two unseen users and a trained one, then one tick."""
    import datetime as dt

    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event

    t0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
    evs = [Event(event="rate", entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=f"i{i}",
                 properties=DataMap({"rating": float(1 + (i % 5))}),
                 event_time=t0 + dt.timedelta(seconds=k))
           for k, (u, i) in enumerate(
               (u, i) for u in ("new_a", "new_b", "u3")
               for i in (1, 5, 9, 30))]
    storage.get_events().insert_batch(evs, app_id)
    summary = worker.tick()
    assert summary["appended"] == 2 and summary["folded"] >= 1, summary


@pytest.mark.parametrize("kind", DEPLOY_KINDS)
def test_every_serving_entry_a_kind_calls_is_warmed(kind, monkeypatch,
                                                    tmp_path):
    """Each registered serving entry wrapped with a counter; the kind's
    queries (inline and a flush at every bucket) and, with fold-in, a
    tick record the entries they call; the kind's warm-up programs
    (``algorithm_programs``, ``foldin.solve_programs``) run through
    ``prebuild`` on the CPU must call every one of them. The only
    entries a path may call unwarmed are the fold-in publication
    scatters, whose notes say so and which launch no hand kernel."""
    from predictionio_tpu_torch.models.recommendation.engine import Query
    from predictionio_tpu_torch.realtime import foldin
    from predictionio_tpu_torch.serving import aot

    entries = _serving_entries()
    algo, model, fold = _kind_model(kind, monkeypatch, tmp_path)
    calls = []
    for name, module, attr in entries:
        real = getattr(module, attr)

        def counted(*a, _name=name, _real=real, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(module, attr, counted)
    algo.predict(model, Query(user="u1", num=5))
    for size in (1, 3, 10, 40):          # the buckets 1, 4, 16 and 64
        got = algo.predict_batch(model, [Query(user=f"u{i}", num=3)
                                         for i in range(size)])
        assert all(len(r.itemScores) == 3 for r in got)
    if fold is not None:
        _tick(*fold)
    path = set(calls)
    calls.clear()
    buckets = aot.serve_buckets(None)
    programs = aot.algorithm_programs(algo, model, buckets)
    if fold is not None:
        programs += foldin.solve_programs(6, "cpu")
    aot.prebuild(programs, "cpu")
    warmed = set(calls)
    notes = aot.registry_snapshot()
    unwarmed = {n for n in notes if "not warmed" in notes[n]["note"]}
    assert path and warmed
    assert path - warmed <= unwarmed, (kind, sorted(path - warmed))
    main = {"fp32": "topk_for_users", "quant_fused":
            "topk_for_users_quant_fused", "quant_plain":
            "topk_for_users_quant", "sharded_fp32": "topk_for_users_sharded",
            "sharded_int8": "topk_for_users_sharded_quant",
            "foldin": "foldin_solve"}[kind]
    assert main in path & warmed
    if kind in ("quant_fused", "sharded_int8"):
        assert {"score_mask_topk_candidates", "merge_candidates"} <= warmed
    # the unwarmed scatters launch no hand kernel (the static pass's view)
    entries_static = {fn.name for m in aot_registration.serving_scope(
        walker.discover(ROOT)) for fn in aot_registration.device_entries(m)}
    assert not unwarmed & entries_static
    assert all("scatter" in n for n in unwarmed)
