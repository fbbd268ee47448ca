"""BENCHMARK.json against the rules of its form, and the import rules."""

import ast
import copy
import subprocess
import sys

import pytest

from conftest import ROOT
from pio_bench import manifest, run

BENCH = ROOT / "pio_bench"


def test_manifest_is_well_formed():
    doc = manifest.read_manifest(ROOT)
    assert manifest.problems(doc, ROOT) == []


@pytest.mark.parametrize("name,ok", [
    ("ml20m-als-r20.train", True), ("train_mfu", True), ("_x", True),
    ("9lives", True), ("a" * 64, True), ("a" * 65, False),
    ("has space", False), ("comma,s", False), ("sl/ash", False),
    (".dot_first", False), ("-dash_first", False), ("µs", False)])
def test_names(name, ok):
    assert (manifest.NAME.fullmatch(name) is not None) is ok


@pytest.mark.parametrize("unit,ok", [
    ("ratings/s", True), ("%", True), ("s", True), ("launches", True),
    ("tokens per s", False), ("µs", False), ("x" * 17, False), ("", False)])
def test_units(unit, ok):
    assert (manifest.UNIT.fullmatch(unit) is not None) is ok


def _broken(edit):
    doc = copy.deepcopy(manifest.read_manifest(ROOT))
    edit(doc)
    return manifest.problems(doc, ROOT)


@pytest.mark.parametrize("edit", [
    lambda d: d["end_to_end"][0].update(bound=0.3),
    lambda d: d["end_to_end"][0].update(bound=0.001),
    lambda d: d["end_to_end"][1].update(name="set up"),
    lambda d: d["per_layer"][0].update(unit="launches per iteration"),
    lambda d: d["per_layer"][0].update(moves="nothing"),
    lambda d: d["per_layer"][0].update(why="a key not in the manifest"),
    lambda d: d["workloads"][0].update(chips=2),
    lambda d: d["workloads"].append(dict(d["workloads"][0], name="x")),
    lambda d: d["configs"][0].update(file="elsewhere/c.json"),
    lambda d: d.update(run_seconds=52),
    lambda d: d.update(command=["python3", "/abs/run.py"]),
    lambda d: d["end_to_end"].pop(1),
], ids=["bound_high", "bound_low", "name", "unit", "moves", "extra_key",
        "chips", "pair_twice", "config_file", "run_seconds", "command",
        "no_setup_s"])
def test_breaches_are_found(edit):
    assert _broken(edit)


def test_every_named_file_exists():
    doc = manifest.read_manifest(ROOT)
    for w in doc["workloads"]:
        cell = manifest.load_cell(ROOT, w["name"])
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert (BENCH / "reference" /
                f"{cell.config['reference']}.py").is_file()
        for name in cell.per_layer:
            assert callable(manifest.reader(cell, name).read)
        assert set(cell.limits["limits"]) == {"layout", "half_step",
                                              "factors", "rmse"}


def test_forbidden_modules_compare_top_level_names_whole():
    loaded = ["predictionio_tpu_torch", "predictionio_tpu_torch.ops.als",
              "jaxtyping", "flaxen", "torch", "predictionio_tpu",
              "predictionio_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert run.forbidden_modules(loaded) == [
        "flax.linen", "jax.numpy", "jaxlib", "predictionio_tpu",
        "predictionio_tpu.ops"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "dataclasses",
                                         "typing", "torch"), (path, mod)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, sys.argv[1])\n"
            "import torch\n"
            "sys.path.insert(0, sys.argv[1] + '/pio_bench/tests')\n"
            "from pio_bench import manifest, run, readings, faults\n"
            "from conftest import _tiny_cell\n"
            "cell = _tiny_cell('ml20m-als-r20.train', sys.argv[1],\n"
            "                  iterations=1)\n"
            "out = manifest.driver(cell).run(cell, 3, 0.0, False,\n"
            "    torch.device('cpu'), time.perf_counter(), log=print)\n"
            "print(run.forbidden_modules(sys.modules), out['correct'])\n")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def test_without_a_card_a_run_exits_non_zero_and_prints_nothing(tmp_path):
    proc = subprocess.run(
        [sys.executable, "pio_bench/run.py", "--workload",
         "ml20m-als-r20.train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                          "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_in_a_bare_checkout_a_run_fails(tmp_path):
    """Only BENCHMARK.json and pio_bench/: the run below the look for a
    card stops at the missing program."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "pio_bench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "import torch\n"
            "from pio_bench import manifest\n"
            "cell = manifest.load_cell('.', 'ml20m-als-r20.train')\n"
            "out = manifest.driver(cell).run(cell, 3, 0.0, False,\n"
            "    torch.device('cpu'), time.perf_counter())\n"
            "print(out)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "predictionio_tpu_torch" in proc.stderr
    assert proc.stdout == ""
