"""The port's on-demand profiling (``common/profiling.py``) and ``pio
profile`` (``tools/profile.py``): the ``dir`` override confined to
PIO_PROFILE_DIR exactly as the reference confines it (400 on absolute
paths, ``..`` and symlink escapes), 403 under PIO_PROFILE_ENABLE=0, 409
while a capture runs, a CPU ``torch.profiler`` capture that leaves a
non-empty Chrome trace and its capture.json, the synchronous ``trace``
of ``pio train --profile``, and the CLI's exit codes (0 artifact, 1
refused, 2 unreachable)."""

import json
import os
import socket
import time

import pytest

from predictionio_tpu.common import profiling as ref_profiling
from predictionio_tpu_torch.common import profiling
from predictionio_tpu_torch.data.api.http import serve_background
from predictionio_tpu_torch.data.api.service import EventAPI
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.tools import cli

import torch_deploy_util as util
from torch_deploy_util import port_cli  # noqa: F401 (fixture)

#: every test starts and ends with the port's storage singleton dropped
#: and the CLI's environment writes registered for undoing
pytestmark = pytest.mark.usefixtures("port_cli")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.delenv("PIO_PROFILE_ENABLE", raising=False)
    monkeypatch.delenv("PIO_PROFILE_MAX_MS", raising=False)
    _wait_idle()
    profiling.reset()
    yield
    _wait_idle()
    profiling.reset()


def _wait_idle(timeout: float = 30.0):
    deadline = time.time() + timeout
    while profiling.list_captures()["active"] is not None:
        assert time.time() < deadline, "a capture never finished"
        time.sleep(0.02)


@pytest.mark.parametrize("raw", [
    None, "", "sub", "a/b/c", "/etc", "../escape", "sub/../../escape",
    "sub/../ok", ".", "link", "link/deeper"])
def test_dir_confinement_matches_the_reference(tmp_path, raw):
    base = tmp_path / "profiles"
    base.mkdir(exist_ok=True)
    outside = tmp_path / "outside"
    outside.mkdir(exist_ok=True)
    if not (base / "link").exists():
        os.symlink(outside, base / "link")
    results = []
    for mod in (ref_profiling, profiling):
        try:
            results.append(("ok", mod.resolve_http_dir(raw)))
        except ValueError as e:
            results.append(("400", str(e)))
    assert results[0] == results[1]
    if raw in ("/etc", "../escape", "sub/../../escape", "link",
               "link/deeper"):
        assert results[1][0] == "400"


@pytest.mark.parametrize("query,status", [
    ({"ms": "abc"}, 400), ({"ms": "50", "dir": "/tmp"}, 400),
    ({"ms": "50", "dir": "../x"}, 400), ({"ms": "0"}, 400)])
def test_bad_posts_answer_400_like_the_reference(query, status):
    want = ref_profiling.handle_route("POST", query)
    got = profiling.handle_route("POST", query)
    assert got[0] == want[0] == status
    assert got[1]["message"].split(" (")[0] == \
        want[1]["message"].split(" (")[0]


def test_disabled_and_wrong_method(monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_ENABLE", "0")
    for mod in (ref_profiling, profiling):
        assert mod.handle_route("POST", {"ms": "10"})[0] == 403
        assert mod.handle_route("PUT", None)[0] == 405
        assert mod.handle_route("GET", None)[0] == 200


def test_cpu_capture_leaves_a_trace_and_409_while_running(monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_MAX_MS", "300")
    status, started = profiling.handle_route("POST", {"ms": "5000",
                                                      "dir": "run1"})
    assert status == 202 and started["boundedMs"] == 300
    busy = profiling.handle_route("POST", {"ms": "10"})
    assert busy[0] == 409 and "already running" in busy[1]["message"]
    _wait_idle()
    (done,) = profiling.list_captures()["captures"]
    assert done["id"] == started["capture"]["id"]
    assert done["state"] == "done" and done["files"] == ["trace.json"]
    assert done["bytes"] > 0
    assert done["dir"].startswith(os.environ["PIO_PROFILE_DIR"])
    with open(os.path.join(done["dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with open(os.path.join(done["dir"], "capture.json")) as f:
        assert json.load(f)["state"] == "done"
    assert profiling.get_capture(done["id"])["bytes"] == done["bytes"]


def test_trace_context_manager_shares_the_guard(tmp_path):
    out = tmp_path / "train_profile"
    with profiling.trace(str(out)):
        with pytest.raises(profiling.CaptureBusy):
            profiling.start_capture(ms=10)
        sum(i * i for i in range(1000))
    assert (out / "trace.json").stat().st_size > 0
    meta = json.loads((out / "capture.json").read_text())
    assert meta["label"] == "train" and meta["state"] == "done"


def test_pio_profile_cli_exit_codes(monkeypatch, capsys):
    """0 for a live daemon's non-empty artifact, 1 when the daemon
    refuses, 2 when nothing listens."""
    api = EventAPI(storage=Storage(env=util.MEM))
    server, port = serve_background(api, "127.0.0.1")
    try:
        url = f"http://127.0.0.1:{port}"
        assert cli.main(["profile", url, "--ms", "100", "-o", "cli"]) == 0
        out = capsys.readouterr().out
        assert "capture done: 1 file(s)" in out and "trace.json" in out
        assert cli.main(["profile", url, "--ms", "100", "-o", "/abs"]) == 1
        monkeypatch.setenv("PIO_PROFILE_ENABLE", "0")
        assert cli.main(["profile", url, "--ms", "100"]) == 1
    finally:
        server.shutdown()
        server.server_close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    assert cli.main(["profile", f"http://127.0.0.1:{dead}", "--ms", "10",
                     "--timeout", "1"]) == 2


def test_pio_train_profile_writes_the_trace_and_the_phase_table(
        monkeypatch, tmp_path):
    """``pio train --telemetry --profile DIR`` on the CPU: the Chrome
    trace, capture.json and telemetry_phases.json in DIR, and the phase
    histogram on /metrics."""
    import shutil

    from predictionio_tpu_torch.common import telemetry

    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    shutil.copy(os.path.join(os.path.dirname(cli.__file__), "..", "models",
                             "recommendation", "engine.json"), engine_dir)
    for name in ("PIO_TELEMETRY", "PIO_SYNTHETIC_EVENTS",
                 "PIO_SYNTHETIC_SEED"):
        monkeypatch.setenv(name, "")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(telemetry, "_override", None)
    prof = tmp_path / "prof"
    assert cli.main(["train", "--engine-dir", str(engine_dir),
                     "--synthetic", "3000", "--telemetry", "--profile",
                     str(prof)]) == 0
    assert os.environ["PIO_TELEMETRY"] == "1"
    assert (prof / "trace.json").stat().st_size > 0
    assert json.loads((prof / "capture.json").read_text())["state"] == \
        "done"
    phases = json.loads((prof / "telemetry_phases.json").read_text())
    assert {"read", "train", "persist"} <= set(phases["phaseSeconds"])
    assert 'pio_train_phase_seconds_count{phase="train"}' in \
        telemetry.registry().exposition()
