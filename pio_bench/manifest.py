"""``BENCHMARK.json`` and the data files it names.

:func:`load_cell` finds everything one cell needs by the names in the
manifest; :func:`problems` checks the manifest against the rules of its
form (names, units, keys, sizes) and is what the CPU tests run.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

#: a name: a letter, digit or ``_`` first, then letters, digits, ``_``,
#: ``.`` and ``-``; at most 64 characters
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("device_trace", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}

BENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One workload of the manifest with the data it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: the metrics the cell reports, name -> unit, in manifest order
    end_to_end: Dict[str, str]
    per_layer: Dict[str, str]
    bench_dir: Path = field(default=BENCH, repr=False)


def read_manifest(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its config,
    traffic and limits read from the benchmark's own files, and the
    metrics it reports. Raises KeyError for a cell the manifest lacks."""
    doc = read_manifest(root)
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    (cfg_entry,) = [c for c in doc["configs"] if c["name"] == w["config"]]
    bench = Path(root) / "pio_bench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(Path(root) / cfg_entry["file"]),
        traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_json(bench / "limits" / f"{name}.json"),
        end_to_end={m["name"]: m["unit"] for m in doc["end_to_end"]
                    if _reports(m, name)},
        per_layer={m["name"]: m["unit"] for m in doc["per_layer"]
                   if _reports(m, name)},
        bench_dir=bench)


def load_module(path: Path, label: str) -> ModuleType:
    """Import one file of the benchmark by path (reader and driver names
    may hold dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod        # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell) -> ModuleType:
    kind = cell.traffic["driver"]
    return load_module(cell.bench_dir / "drivers" / f"{kind}.py",
                       f"pio_bench_driver_{kind}")


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.bench_dir / "layer_metrics" / f"{metric}.py",
                       "pio_bench_reader_" + re.sub(r"\W", "_", metric))


# ---------------------------------------------------------------------------
# the rules of the manifest's form
# ---------------------------------------------------------------------------

def _line(text, most: int = 200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def _name_ok(text) -> bool:
    return isinstance(text, str) and NAME.fullmatch(text) is not None


def problems(doc: dict, root: Path) -> List[str]:
    """Every breach of the rules of the manifest's form found in ``doc``
    (empty when the manifest is well formed). ``root`` is the checkout,
    for the files the manifest names."""
    out: List[str] = []
    if set(doc) != set(TOP_KEYS):
        out.append(f"top-level keys {sorted(doc)}")
    paths = doc.get("paths", [])
    if not 1 <= len(paths) <= 16:
        out.append("paths: 1 to 16 directories")
    for p in paths:
        if not (isinstance(p, str) and PATH.fullmatch(p)
                and not p.startswith("/") and ".." not in p.split("/")):
            out.append(f"path {p!r}")
    cmd = doc.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command: 1 to 32 words of 1 to 200 characters")
    for w in cmd:
        if w.startswith("/") or ".." in w.split("/"):
            out.append(f"command word {w!r} leaves the checkout")
        if "/" in w and (Path(root) / w).exists() and not any(
                w == p or w.startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"command word {w!r} names a file outside paths")
    rs = doc.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds: a whole number from 1 to 51")
    elif 2 * 24 * 90 + (2 + 14 * 24) * (rs + 60) + 1200 > 43200:
        out.append("run_seconds: 24 cells would not fit in a check")

    configs = doc.get("configs", [])
    if not 1 <= len(configs) <= 24:
        out.append("configs: 1 to 24")
    for c in configs:
        if set(c) != CONFIG_KEYS:
            out.append(f"config keys {sorted(c)}")
        if not _name_ok(c.get("name")):
            out.append(f"config name {c.get('name')!r}")
        if not (_line(c.get("source")) and _line(c.get("why"))):
            out.append(f"config {c.get('name')}: source / why")
        f = c.get("file", "")
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths) or \
                not (Path(root) / f).is_file():
            out.append(f"config file {f!r} not under paths")
        red = c.get("reduced", [])
        if len(red) > 16 or not all(_name_ok(k) for k in red):
            out.append(f"config {c.get('name')}: reduced")
    if len({c.get("file") for c in configs}) != len(configs):
        out.append("two configs share a file")
    config_names = {c.get("name") for c in configs}

    cells = doc.get("workloads", [])
    if not 1 <= len(cells) <= 24:
        out.append("workloads: 1 to 24")
    pairs = set()
    for w in cells:
        if set(w) != WORKLOAD_KEYS:
            out.append(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            if not _name_ok(w.get(k)):
                out.append(f"workload {k} {w.get(k)!r}")
        if w.get("config") not in config_names:
            out.append(f"workload {w.get('name')}: unknown config")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips")
        if not _line(w.get("why")):
            out.append(f"workload {w.get('name')}: why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"config and traffic {pair} twice")
        pairs.add(pair)
    if sum(w.get("chips") == 4 for w in cells) > max(1, len(cells) // 4):
        out.append("too many four-chip cells")
    used = {w.get("config") for w in cells}
    if config_names - used:
        out.append(f"configs no cell uses: {sorted(config_names - used)}")
    cell_names = [w.get("name") for w in cells]

    e2e = doc.get("end_to_end", [])
    layer = doc.get("per_layer", [])
    if not 1 <= len(e2e) <= 16:
        out.append("end_to_end: 1 to 16")
    if not 1 <= len(layer) <= 128:
        out.append("per_layer: 1 to 128")
    for m in e2e:
        if set(m) - {"workloads"} != E2E_KEYS:
            out.append(f"end_to_end keys {sorted(m)}")
        if m.get("source") not in END_TO_END_SOURCES:
            out.append(f"{m.get('name')}: source")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            out.append(f"{m.get('name')}: bound {b}")
    if "setup_s" not in [m.get("name") for m in e2e]:
        out.append("no setup_s")
    e2e_names = {m.get("name") for m in e2e}
    for m in layer:
        if set(m) - {"workloads"} != LAYER_KEYS:
            out.append(f"per_layer keys {sorted(m)}")
        if m.get("source") not in SOURCES:
            out.append(f"{m.get('name')}: source")
        if m.get("moves") not in e2e_names:
            out.append(f"{m.get('name')}: moves {m.get('moves')!r}")
        if not _line(m.get("layer")):
            out.append(f"{m.get('name')}: layer")
    for m in e2e + layer:
        if not _name_ok(m.get("name")):
            out.append(f"metric name {m.get('name')!r}")
        if not (isinstance(m.get("unit"), str)
                and UNIT.fullmatch(m["unit"])):
            out.append(f"{m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"{m.get('name')}: better")
        for c in m.get("workloads", []):
            if c not in cell_names:
                out.append(f"{m.get('name')}: unknown workload {c}")
    for kind, group in (("metric", e2e + layer), ("workload", cells),
                        ("config", configs)):
        seen = [x.get("name") for x in group]
        if len(set(seen)) != len(seen):
            out.append(f"two {kind}s share a name")
    for c in cell_names:
        reported = [m["name"] for m in e2e if _reports(m, c)]
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{c}: setup_s and one more end-to-end metric")
        if not any(_reports(m, c) for m in layer):
            out.append(f"{c}: no per-layer metric")
        for m in layer:
            moved = [e for e in e2e if e.get("name") == m.get("moves")]
            if _reports(m, c) and moved and not _reports(moved[0], c):
                out.append(f"{m['name']} in {c}, which lacks {m['moves']}")
    if len(json.dumps(doc).encode()) > 64 * 1024:
        out.append("manifest over 64 KiB")
    return out
