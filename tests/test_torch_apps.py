"""The port's app, channel and access-key lifecycle, ``pio import`` and
``pio export``, ``pio status`` and the dashboard and admin daemons, on
memory and SQLite; and SQLite stores that either package writes read back
in the other."""

import datetime as dt
import json
import ssl
import subprocess
import threading

import pytest

from predictionio_tpu.data import storage as ref_storage_mod
from predictionio_tpu.tools import cli as ref_cli
from predictionio_tpu.tools import transfer as ref_transfer
from predictionio_tpu_torch.data import storage as storage_mod
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    AccessKey, Channel, EvaluationInstance, Storage,
)
from predictionio_tpu_torch.tools import apps as app_cmds
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.tools.admin import AdminAPI
from predictionio_tpu_torch.tools.dashboard import DashboardAPI
from predictionio_tpu_torch.tools.transfer import (
    events_to_file, file_to_events,
)

from torch_deploy_util import port_cli  # noqa: F401 (fixture)

#: every test starts and ends with the port's storage singleton dropped
#: and the CLI's environment writes registered for undoing
pytestmark = pytest.mark.usefixtures("port_cli")


MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}


@pytest.fixture(params=["memory", "sqlite"])
def port_store(request, tmp_path, monkeypatch):
    """The port's storage singleton on a fresh memory or SQLite store."""
    for k in list(MEM):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    store = Storage(env=MEM if request.param == "memory" else None)
    monkeypatch.setattr(storage_mod, "_storage", store)
    return store


@pytest.fixture()
def both_on_sqlite(tmp_path, monkeypatch):
    """Both packages' storage singletons on one SQLite store."""
    for k in list(MEM):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    ref_storage_mod.reset_storage()
    monkeypatch.setattr(storage_mod, "_storage", None)
    yield tmp_path
    ref_storage_mod.reset_storage()


def _rate_lines(n, start=0):
    t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
    return [Event(event="rate", entity_type="user", entity_id=f"u{i % 7}",
                  event_id=f"ev{i}", target_entity_type="item",
                  target_entity_id=f"i{i % 5}",
                  properties=DataMap({"rating": float(i % 5 + 1)}),
                  event_time=t0 + dt.timedelta(minutes=i),
                  creation_time=t0).to_json()
            for i in range(start, start + n)]


def test_app_lifecycle_through_the_cli(port_store, capsys):
    assert cli.main(["app", "new", "CliApp", "--access-key", "ck"]) == 0
    assert "Access Key: ck" in capsys.readouterr().out
    assert cli.main(["app", "new", "CliApp"]) == 1
    assert "already exists" in capsys.readouterr().err
    assert cli.main(["app", "new", "Other", "--id", "7"]) == 0
    assert cli.main(["app", "new", "Third", "--id", "7"]) == 1
    assert "App ID 7 already exists" in capsys.readouterr().err
    assert cli.main(["app", "list"]) == 0
    out = capsys.readouterr().out
    assert "CliApp" in out and "Finished listing 2 app(s)." in out
    assert cli.main(["app", "channel-new", "CliApp", "mobile"]) == 0
    assert cli.main(["app", "channel-new", "CliApp", "mobile"]) == 1
    assert cli.main(["app", "channel-new", "CliApp", "bad name!"]) == 1
    assert "is invalid" in capsys.readouterr().err
    assert cli.main(["app", "show", "CliApp"]) == 0
    out = capsys.readouterr().out
    assert "Channel: mobile (ID 1)" in out and "ck | (all)" in out
    assert cli.main(["accesskey", "new", "CliApp", "--event", "view",
                     "--event", "rate"]) == 0
    keys = app_cmds.accesskey_list("CliApp", storage=port_store)
    assert {tuple(k.events) for k in keys} == {(), ("view", "rate")}
    extra = next(k for k in keys if k.events)
    assert len(extra.key) == 64
    assert cli.main(["accesskey", "list"]) == 0
    assert "view,rate" in capsys.readouterr().out
    assert cli.main(["accesskey", "delete", extra.key]) == 0
    assert cli.main(["accesskey", "delete", extra.key]) == 1
    app_id = port_store.get_meta_data_apps().get_by_name("CliApp").id
    events = port_store.get_events()
    events.insert(Event(event="x", entity_type="user", entity_id="a"),
                  app_id)
    events.insert(Event(event="x", entity_type="user", entity_id="b"),
                  app_id, 1)
    assert cli.main(["app", "data-delete", "CliApp", "-f"]) == 0
    assert list(events.find(app_id)) == []
    assert len(list(events.find(app_id, 1))) == 1
    assert cli.main(["app", "data-delete", "CliApp", "--all", "-f"]) == 0
    assert list(events.find(app_id, 1)) == []
    assert cli.main(["app", "channel-delete", "CliApp", "mobile", "-f"]) == 0
    assert cli.main(["app", "channel-delete", "CliApp", "mobile", "-f"]) == 1
    assert cli.main(["app", "delete", "CliApp", "-f"]) == 0
    assert cli.main(["app", "show", "CliApp"]) == 1
    assert port_store.get_meta_data_access_keys().get("ck") is None
    assert [d.app.name for d in app_cmds.list_apps(port_store)] == ["Other"]


def test_dao_round_trips(port_store):
    keys = port_store.get_meta_data_access_keys()
    assert keys.insert(AccessKey("k1", 3, ("a", "b"))) == "k1"
    assert keys.insert(AccessKey("k1", 4, ())) is None
    keys.update(AccessKey("k1", 3, ("c",)))
    assert keys.get("k1") == AccessKey("k1", 3, ("c",))
    channels = port_store.get_meta_data_channels()
    assert channels.insert(Channel(5, "c-5", 3)) == 5
    assert channels.insert(Channel(0, "next", 3)) == 6
    assert channels.get(5) == Channel(5, "c-5", 3)
    with pytest.raises(ValueError, match="Invalid channel name"):
        Channel(0, "x" * 17, 3)
    apps = port_store.get_meta_data_apps()
    app_id = apps.insert(storage_mod.App(0, "A", "d"))
    apps.update(storage_mod.App(app_id, "B", None))
    assert apps.get_all() == [storage_mod.App(app_id, "B", None)]
    apps.delete(app_id)
    assert apps.get(app_id) is None
    events = port_store.get_events()
    eid = events.insert(Event(event="x", entity_type="u", entity_id="1"), 3)
    assert events.get(eid, 3).entity_id == "1"
    assert events.get(eid, 3, 5) is None
    assert events.delete(eid, 3) and not events.delete(eid, 3)
    events.close()


def test_import_export_round_trip(port_store, tmp_path, capsys):
    d = app_cmds.create("IoApp", storage=port_store)
    channel = app_cmds.channel_new("IoApp", "side", storage=port_store)
    src = tmp_path / "events.json"
    src.write_text("\n".join(_rate_lines(12)) + "\n\n")
    assert cli.main(["import", "--appid", str(d.app.id), "--input",
                     str(src)]) == 0
    assert "Imported 12 events." in capsys.readouterr().out
    side = tmp_path / "side.json"
    side.write_text("\n".join(_rate_lines(3, start=100)) + "\n")
    assert file_to_events(str(side), d.app.id, channel="side",
                          storage=port_store) == 3
    out = tmp_path / "out.json"
    assert cli.main(["export", "--appid", str(d.app.id), "--output",
                     str(out)]) == 0
    # the lines are the canonical wire form, so the file comes back byte
    # for byte, and so does the reference's export of the same store
    assert out.read_bytes() == src.read_bytes().rstrip(b"\n") + b"\n"
    ref_out = tmp_path / "ref_out.json"
    # on SQLite the reference opens the same file itself; the memory store
    # lives in this process only, so it is handed over as it is
    on_sqlite = "PIO_STORAGE_SOURCES_M_TYPE" not in port_store._env
    assert ref_transfer.events_to_file(
        str(ref_out), d.app.id,
        storage=ref_storage_mod.Storage() if on_sqlite else port_store) == 12
    assert ref_out.read_bytes() == out.read_bytes()
    assert events_to_file(str(tmp_path / "o2.json"), d.app.id,
                          channel="side", storage=port_store) == 3
    assert (tmp_path / "o2.json").read_bytes() == side.read_bytes()
    assert channel.name == "side"
    with pytest.raises(app_cmds.CommandError, match="Channel nope"):
        events_to_file(str(tmp_path / "o3.json"), d.app.id, channel="nope",
                       storage=port_store)
    bad = tmp_path / "bad.json"
    bad.write_text('{"event": "x"}\n')
    assert cli.main(["import", "--appid", str(d.app.id), "--input",
                     str(bad)]) == 1
    assert "bad.json:1" in capsys.readouterr().err


def test_reference_store_reads_in_the_port(both_on_sqlite, capsys):
    """``pio app new`` + ``pio import`` of the JAX package; the port's
    ``app show``, ``accesskey list`` and ``export`` read them."""
    tmp = both_on_sqlite
    src = tmp / "in.json"
    src.write_text("\n".join(_rate_lines(20)) + "\n")
    assert ref_cli.main(["app", "new", "RefApp", "--access-key", "rk"]) == 0
    assert ref_cli.main(["app", "channel-new", "RefApp", "web"]) == 0
    assert ref_cli.main(["accesskey", "new", "RefApp", "--key", "rk2",
                         "--event", "rate"]) == 0
    assert ref_cli.main(["import", "--appid", "1", "--input",
                         str(src)]) == 0
    assert ref_cli.main(["import", "--appid", "1", "--channel", "web",
                         "--input", str(src)]) == 0
    capsys.readouterr()
    assert cli.main(["app", "show", "RefApp"]) == 0
    out = capsys.readouterr().out
    assert "Access Key: rk | (all)" in out
    assert "Access Key: rk2 | rate" in out and "Channel: web (ID 1)" in out
    assert cli.main(["accesskey", "list", "RefApp"]) == 0
    assert "rk2 | app 1 | rate" in capsys.readouterr().out
    out = tmp / "out.json"
    assert cli.main(["export", "--appid", "1", "--output", str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()
    assert cli.main(["export", "--appid", "1", "--channel", "web",
                     "--output", str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()
    assert cli.main(["status"]) == 0
    assert "Your system is all ready to go." in capsys.readouterr().out


def test_port_store_reads_in_the_reference(both_on_sqlite, capsys):
    tmp = both_on_sqlite
    src = tmp / "in.json"
    src.write_text("\n".join(_rate_lines(20)) + "\n")
    assert cli.main(["app", "new", "PortApp", "--access-key", "pk"]) == 0
    assert cli.main(["app", "channel-new", "PortApp", "web"]) == 0
    assert cli.main(["accesskey", "new", "PortApp", "--key", "pk2",
                     "--event", "buy"]) == 0
    assert cli.main(["import", "--appid", "1", "--channel", "web",
                     "--input", str(src)]) == 0
    assert cli.main(["import", "--appid", "1", "--input", str(src)]) == 0
    capsys.readouterr()
    assert ref_cli.main(["app", "show", "PortApp"]) == 0
    out = capsys.readouterr().out
    assert "Access Key: pk | (all)" in out
    assert "Access Key: pk2 | buy" in out and "Channel: web (ID 1)" in out
    assert ref_cli.main(["accesskey", "list", "PortApp"]) == 0
    assert "pk2 | app 1 | buy" in capsys.readouterr().out
    for channel in (None, "web"):
        out = tmp / "out.json"
        argv = ["export", "--appid", "1", "--output", str(out)]
        assert ref_cli.main(argv + (["--channel", channel]
                                    if channel else [])) == 0
        assert out.read_bytes() == src.read_bytes()
    # the reference deletes what the port made
    assert ref_cli.main(["app", "delete", "PortApp", "-f"]) == 0
    assert cli.main(["app", "list"]) == 0
    assert "Finished listing 0 app(s)." in capsys.readouterr().out


def test_status_refuses_a_missing_card(port_store, monkeypatch, capsys):
    import torch
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["status"]) == 1
    assert "cuda" in capsys.readouterr().err


def test_admin_api(port_store):
    api = AdminAPI(storage=port_store)
    assert api.handle("GET", "/")[0] == 200
    status, body = api.handle("POST", "/cmd/app",
                              body=json.dumps({"name": "AdminApp"}).encode())
    assert status == 201 and body["name"] == "AdminApp"
    assert len(body["accessKeys"]) == 1
    status, listing = api.handle("GET", "/cmd/app")
    assert status == 200 and listing[0]["name"] == "AdminApp"
    assert api.handle("POST", "/cmd/app",
                      body=json.dumps({"name": "AdminApp"}).encode())[0] \
        == 400
    assert api.handle("POST", "/cmd/app", body=b"{}")[0] == 400
    assert api.handle("DELETE", "/cmd/app/AdminApp/data")[0] == 200
    assert api.handle("DELETE", "/cmd/app/AdminApp")[0] == 200
    assert api.handle("GET", "/cmd/app")[1] == []
    # the telemetry routes answer before the key check, as the
    # reference's, the metrics history among them
    status, text, headers = api.handle("GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith(
        "text/plain; version=0.0.4")
    status, body = api.handle("GET", "/debug/history.json")[:2]
    assert status == 200 and "samples" in body


def test_dashboard_lists_completed_evaluations(port_store):
    now = dt.datetime.now(dt.timezone.utc)
    instances = port_store.get_meta_data_evaluation_instances()
    iid = instances.insert(EvaluationInstance(
        id="", status="EVALCOMPLETED", start_time=now, end_time=now,
        evaluation_class="my.Evaluation",
        evaluator_results_html="<p>score 0.5</p>",
        evaluator_results_json='{"bestIdx": 0}'))
    instances.insert(EvaluationInstance(
        id="", status="INIT", start_time=now, end_time=now,
        evaluation_class="pending.Eval"))
    api = DashboardAPI(storage=port_store)
    status, page = api.handle("GET", "/")
    assert status == 200 and "my.Evaluation" in page
    assert "pending.Eval" not in page
    assert api.handle("GET", f"/engine_instances/{iid}.json") == \
        (200, {"bestIdx": 0})
    status, page = api.handle("GET", f"/engine_instances/{iid}.html")
    assert status == 200 and "score 0.5" in page
    assert api.handle("GET", "/engine_instances/zzz.json")[0] == 404
    assert api.handle("POST", "/")[0] == 405
    from predictionio_tpu_torch.data.api.http import dispatch_request
    out = dispatch_request(api, "GET", "/", b"", {})
    assert (out.status, out.ctype) == (200, "text/html; charset=UTF-8")
    assert b"my.Evaluation" in out.data


@pytest.mark.parametrize("api_cls", [AdminAPI, DashboardAPI])
def test_server_key(port_store, monkeypatch, api_cls):
    api = api_cls(storage=port_store, server_key="tok")
    assert api.handle("GET", "/", headers={})[0] == 401
    assert api.handle("GET", "/", headers={"X-PIO-Server-Key": "tok"})[0] \
        == 200
    assert api.handle("GET", "/", query={"accessKey": "tok"})[0] == 200
    assert api.handle("GET", "/", query={"accessKey": "wrong"})[0] == 401
    assert api.handle("GET", "/healthz")[0] == 200      # probes hold no key
    monkeypatch.setenv("PIO_SERVER_KEY", "envtok")       # read, not inert
    api = api_cls(storage=port_store)
    assert api.handle("GET", "/")[0] == 401
    assert api.handle("GET", "/", query={"accessKey": "envtok"})[0] == 200
    monkeypatch.delenv("PIO_SERVER_KEY")
    assert api_cls(storage=port_store).handle("GET", "/")[0] == 200


def test_tls_end_to_end(port_store, tmp_path, monkeypatch):
    """A self-signed PIO_SSL_CERTFILE/PIO_SSL_KEYFILE pair puts the
    port's transport on https."""
    cert, key = tmp_path / "srv.crt", tmp_path / "srv.key"
    try:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=localhost"],
            check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("openssl unavailable")
    monkeypatch.setenv("PIO_SSL_CERTFILE", str(cert))
    monkeypatch.setenv("PIO_SSL_KEYFILE", str(key))
    from predictionio_tpu_torch.data.api.http import make_server
    import http.client

    server = make_server(AdminAPI(storage=port_store, server_key="tok"),
                         "127.0.0.1", 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        conn = http.client.HTTPSConnection("127.0.0.1", port, context=ctx,
                                           timeout=10)
        conn.request("GET", "/", headers={"X-PIO-Server-Key": "tok"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["status"] == "alive"
        plain = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        with pytest.raises(Exception):
            plain.request("GET", "/")
            plain.getresponse()
    finally:
        server.shutdown()
        server.server_close()
