"""A configuration, a cell and a per-layer metric added as new files and
new manifest entries only: the harness finds and runs them without an
edit to any file it already has."""

import hashlib
import json
import shutil

from pio_bench import manifest

from conftest import ROOT, TINY


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "pio_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and "_build" not in p.parts}


def test_a_new_cell_needs_only_new_files(tmp_path, run_cpu):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pio_bench", tmp_path / "pio_bench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = _digests(tmp_path)
    bench = tmp_path / "pio_bench"

    cfg = json.loads((bench / "configs" / "ml20m-als-r20.json").read_text())
    cfg.update(name="tiny-als-r4", rank=4, **TINY)
    (bench / "configs" / "tiny-als-r4.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "train_twice_warm.json").write_text(json.dumps(
        {"driver": "train", "warm_iterations": 2}))
    (bench / "limits" / "tiny-als-r4.train_twice_warm.json").write_text(
        json.dumps({"limits": {"layout": 0, "half_step": 1e-3,
                               "factors": 1e-2, "rmse": 1e-4}}))
    (bench / "layer_metrics" / "ratings_per_call.py").write_text(
        "def read(ctx):\n"
        "    return ctx.config['n_ratings'] if ctx.calls else None\n")

    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({
        "name": "tiny-als-r4", "source": "a test", "reduced": [],
        "file": "pio_bench/configs/tiny-als-r4.json", "why": "a test"})
    cell = "tiny-als-r4.train_twice_warm"
    doc["workloads"].append({"name": cell, "config": "tiny-als-r4",
                             "traffic": "train_twice_warm", "chips": 1,
                             "why": "a test"})
    doc["per_layer"].append({
        "name": "ratings_per_call", "unit": "ratings", "better": "higher",
        "source": "program_counter", "layer": "trainer loop",
        "moves": "train_ratings_per_s", "workloads": [cell]})
    for m in doc["end_to_end"]:
        assert "workloads" not in m      # reported by every cell, new ones too
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    assert manifest.problems(doc, tmp_path) == []
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

    found = manifest.load_cell(tmp_path, cell)
    assert found.config["rank"] == 4 and found.traffic["warm_iterations"] == 2
    assert list(found.per_layer) == ["ratings_per_call"]
    assert manifest.reader(found, "ratings_per_call").read(
        type("Ctx", (), {"calls": 1, "config": found.config})) == \
        TINY["n_ratings"]
    out = run_cpu(found)
    assert out["correct"], out["checks"]
    # the cells already there are found as before
    assert manifest.load_cell(tmp_path, "ml20m-als-r20.train").per_layer == \
        manifest.load_cell(ROOT, "ml20m-als-r20.train").per_layer
