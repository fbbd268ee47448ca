"""The console verbs ``build``, ``run``, ``shell``, ``template``,
``unregister`` and ``upgrade`` of the port against the JAX package's, on
the CPU, in process: exit codes and output compared **exactly** where the
verbs say the same thing (``build``'s validation lines and errors,
``run``'s exit code and output, ``unregister`` and ``upgrade``), and
``template`` naming the port's packages and every example module."""

import importlib
import io
import json
import re

import pytest

from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch.tools import cli


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))


def _both(capsys, argv):
    """[(rc, stdout, stderr)] of the port's and the JAX package's pio."""
    out = []
    for main in (cli.main, jcli.main):
        rc = main(list(argv))
        o, e = capsys.readouterr()
        out.append((rc, o, e))
    return out


def _engine_dir(tmp_path, variant):
    d = tmp_path / "engine"
    d.mkdir(exist_ok=True)
    (d / "engine.json").write_text(json.dumps(variant))
    return str(d)


FILTERING = {
    "id": "ml", "engineFactory":
        "predictionio_tpu.examples.movielens:filtering_engine",
    "datasource": {"params": {"appName": "MyApp"}},
    "algorithms": [{"name": "als", "params": {"rank": 10,
                                              "numIterations": 10,
                                              "lambda": 0.01, "seed": 3}}],
    "serving": {"params": {"filepath": "disabled.txt"}},
}


@pytest.mark.parametrize("variant", [
    FILTERING,
    {**FILTERING, "engineFactory":
        "predictionio_tpu.examples.dimsum:engine",
     "algorithms": [{"name": "dimsum", "params": {"threshold": 0.1}}],
     "serving": {}},
    {**FILTERING, "engineFactory":
        "predictionio_tpu.examples.regression:engine",
     "datasource": {"params": {"filepath": "x.txt", "k": 3}},
     "algorithms": [{"name": "SGD", "params": {"stepSize": 0.5}}],
     "serving": {}},
])
def test_build_validates_as_the_reference(capsys, tmp_path, variant):
    d = _engine_dir(tmp_path, variant)
    port, ref = _both(capsys, ["build", "--engine-dir", d])
    assert port == ref
    assert port[0] == 0 and "validated (variant ml)" in port[1]


@pytest.mark.parametrize("broken", [
    {"algorithms": [{"name": "als", "params": {"rank": 10,
                                               "nope": 1}}]},
    {"datasource": {"params": {}}},
    {"serving": {"params": {"filepath": "f", "extra": 1}}},
])
def test_build_refuses_a_broken_variant_as_the_reference(capsys, tmp_path,
                                                         broken):
    d = _engine_dir(tmp_path, {**FILTERING, **broken})
    port, ref = _both(capsys, ["build", "--engine-dir", d])
    assert port == ref and port[0] == 1 and port[2].startswith("[ERROR]")


def test_build_names_a_missing_counterpart(capsys, tmp_path):
    d = _engine_dir(tmp_path, {**FILTERING, "engineFactory":
                               "predictionio_tpu.examples.nosuch:engine"})
    assert cli.main(["build", "--engine-dir", d]) == 1
    err = capsys.readouterr().err
    assert "predictionio_tpu_torch.examples.nosuch:engine" in err


def test_run_calls_a_callable_in_the_engine_dir(capsys, tmp_path):
    d = tmp_path / "engine"
    d.mkdir()
    (d / "smoke_main.py").write_text(
        "def main(*args):\n"
        "    print('ran', args)\n"
        "    return len(args)\n"
        "def quiet():\n"
        "    pass\n")
    for argv, rc in ((["smoke_main:main", "a", "b"], 2),
                     (["smoke_main:quiet"], 0)):
        port, ref = _both(capsys, ["run", *argv, "--engine-dir", str(d)])
        assert port == ref and port[0] == rc


@pytest.mark.parametrize("verb", ["unregister", "upgrade"])
def test_unregister_and_upgrade_exit_1_with_the_reference_message(
        capsys, verb):
    port, ref = _both(capsys, [verb])
    assert port == ref and port[0] == 1 and port[2]


def test_template_names_the_port_and_every_example(capsys):
    assert cli.main(["template"]) == 0
    out = capsys.readouterr().out
    assert "predictionio_tpu_torch.models" in out
    assert "predictionio_tpu_torch.examples" in out
    listed = re.search(r"examples\.\* — (.*?);", out).group(1).split(", ")
    assert len(listed) == 11
    for name in listed:
        importlib.import_module(f"predictionio_tpu_torch.examples.{name}")
    assert cli.main(["template", "list"]) == 0


def test_shell_runs_piped_stdin_with_torch_and_storage(capsys, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "print(type(storage).__name__, torch.__name__)\n"
        "apps = storage.get_meta_data_apps().get_all()\n"
        "print('apps', len(apps), store.__name__)\n"))
    assert cli.main(["shell"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "Storage torch", "apps 0 predictionio_tpu_torch.data.store"]


def test_every_verb_of_the_reference_but_lint_dispatches():
    # the port's lint landed too: every reference verb dispatches
    assert set(jcli._DISPATCH) - set(cli._DISPATCH) == set()
