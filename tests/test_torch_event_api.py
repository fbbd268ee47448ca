"""The port's event server against the JAX package's, request for request.

Every case of ``tests/test_event_api.py`` is replayed here: each request
goes through the reference's ``EventAPI`` and the port's, each on its own
in-memory store seeded with the same app, access keys and channel, and
both through their transport's ``dispatch_request``. The answers must be
byte-identical (status, body and content type) and the stored rows equal.
Requests carry ``eventId``, ``eventTime`` and ``creationTime`` wherever the
server would otherwise mint them; the webhook cases, whose connectors
build the event, compare with only ``eventId`` and ``creationTime``
masked. The telemetry routes answer as the reference's; its
``/debug/history.json`` (the metrics flight recorder, not ported yet)
answers 404 like any unknown path.
"""

import base64
import datetime as dt
import json
import urllib.error
import urllib.parse
import urllib.request

import pytest

from predictionio_tpu.data.api import service as ref_service
from predictionio_tpu.data.api import stats as ref_stats
from predictionio_tpu.data.api.http import (
    dispatch_request as ref_dispatch, serve_background as ref_serve,
)
from predictionio_tpu.data.api.plugins import (
    EventServerPluginContext as RefPluginContext,
)
from predictionio_tpu.data.storage import (
    AccessKey as RefAccessKey, App as RefApp, Channel as RefChannel,
    Storage as RefStorage,
)
from predictionio_tpu_torch.data.api import service
from predictionio_tpu_torch.data.api import stats
from predictionio_tpu_torch.data.api.http import (
    dispatch_request, serve_background,
)
from predictionio_tpu_torch.data.api.plugins import (
    INPUT_BLOCKER, EventServerPluginContext,
)
from predictionio_tpu_torch.data.storage import (
    AccessKey, App, Channel, Storage,
)

MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
T0 = "2021-01-01T00:00:00.000Z"
FROZEN = dt.datetime(2024, 5, 6, 7, 8, 9, 123000, tzinfo=dt.timezone.utc)
WEBHOOK_MASK = ("eventId", "creationTime")


def _seed(storage, app_cls, key_cls, channel_cls):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "testapp", None))
    storage.get_events().init(app_id)
    keys = storage.get_meta_data_access_keys()
    keys.insert(key_cls("secret", app_id, ()))
    keys.insert(key_cls("limited", app_id, ("view",)))
    cid = storage.get_meta_data_channels().insert(
        channel_cls(0, "mobile", app_id))
    storage.get_events().init(app_id, cid)
    return app_id, cid


class Blocker:
    """One plugin object serves both registries (they only read these
    attributes), so ``/plugins.json`` names the same class on both."""
    plugin_name = "strict"
    plugin_description = "rejects buy events"
    plugin_type = INPUT_BLOCKER

    def process(self, info, context):
        if info.event.event == "buy":
            raise ValueError("buy blocked")

    def handle_rest(self, app_id, channel_id, args):
        return json.dumps({"args": list(args)})


def _masked(payload, mask):
    if isinstance(payload, list):
        return [_masked(p, mask) for p in payload]
    if isinstance(payload, dict):
        return {k: ("<masked>" if k in mask else _masked(v, mask))
                for k, v in payload.items()}
    return payload


class Pair:
    """The reference's and the port's event server side by side."""

    def __init__(self):
        self.ref_store = RefStorage(env=MEM)
        self.store = Storage(env=MEM)
        self.app_id, self.cid = _seed(self.ref_store, RefApp, RefAccessKey,
                                      RefChannel)
        assert _seed(self.store, App, AccessKey, Channel) == \
            (self.app_id, self.cid)
        self.build()

    def build(self, stats_on=False, plugins=()):
        self.ref = ref_service.EventAPI(
            storage=self.ref_store,
            config=ref_service.EventServerConfig(stats=stats_on),
            plugin_context=RefPluginContext(list(plugins)))
        self.port = service.EventAPI(
            storage=self.store,
            config=service.EventServerConfig(stats=stats_on),
            plugin_context=EventServerPluginContext(list(plugins)))

    def send(self, method, target, body=b"", headers=None, mask=(),
             port_target=None):
        """One request through both; returns (status, reference JSON,
        port JSON). Without ``mask`` the answers must be byte-identical."""
        out = ref_dispatch(self.ref, method, target, body, dict(headers or {}))
        got = dispatch_request(
            self.port, method, port_target or target, body,
            dict(headers or {}))
        status, data, ctype = got.status, got.data, got.ctype
        if not mask:
            assert (status, data, ctype) == (out.status, out.data, out.ctype)
        else:
            assert (status, ctype) == (out.status, out.ctype)
            assert _masked(json.loads(data), mask) == \
                _masked(json.loads(out.data), mask)
        return status, json.loads(out.data), json.loads(data)

    def rows(self, mask=()):
        """Every stored event of both channels, equal on both sides;
        returns the default channel's count."""
        counts = []
        for cid in (None, self.cid):
            ref = [e.to_dict() for e in self.ref_store.get_events().find(
                app_id=self.app_id, channel_id=cid)]
            got = [e.to_dict() for e in self.store.get_events().find(
                app_id=self.app_id, channel_id=cid)]
            assert _masked(got, mask) == _masked(ref, mask)
            counts.append(len(ref))
        return counts[0]


def ev(name="rate", entity="u0", eid=None, **kw):
    d = {"event": name, "entityType": "user", "entityId": entity,
         "eventTime": T0, "creationTime": T0}
    if eid is not None:
        d["eventId"] = eid
    d.update(kw)
    return json.dumps(d).encode()


def q(target, key="secret", **params):
    query = {"accessKey": key, **params} if key else params
    return target + ("?" + urllib.parse.urlencode(query) if query else "")


# ---------------------------------------------------------------- cases

def case_alive_and_unknown_route(p, monkeypatch):
    assert p.send("GET", "/")[0] == 200
    assert p.send("GET", "/nope.json")[0] == 404
    assert p.send("GET", "/healthz")[0] == 200
    assert p.send("GET", "/readyz")[0] == 200
    assert p.send("GET", "/plugins.json")[0] == 200


def case_auth_missing_invalid_and_basic_header(p, monkeypatch):
    status, body, _ = p.send("POST", "/events.json", ev(eid="a1"))
    assert status == 401 and "Missing" in body["message"]
    assert p.send("POST", q("/events.json", "wrong"), ev(eid="a2"))[0] == 401
    hdr = {"Authorization": "Basic " + base64.b64encode(b"secret:").decode()}
    status, body, _ = p.send("POST", "/events.json", ev(eid="a3"), hdr)
    assert status == 201 and body == {"eventId": "a3"}
    bad = {"Authorization": "Basic !!notbase64"}
    assert p.send("POST", "/events.json", ev(eid="a4"), bad)[0] == 401
    assert p.rows() == 1


def case_post_get_delete_event(p, monkeypatch):
    status, body, _ = p.send("POST", q("/events.json"), ev(eid="e1"))
    assert (status, body) == (201, {"eventId": "e1"})
    status, got, _ = p.send("GET", q("/events/e1.json"))
    assert status == 200 and got["event"] == "rate" and got["eventId"] == "e1"
    assert p.rows() == 1
    assert p.send("DELETE", q("/events/e1.json"))[:2] == \
        (200, {"message": "Found"})
    assert p.send("GET", q("/events/e1.json"))[0] == 404
    assert p.send("DELETE", q("/events/e1.json"))[0] == 404
    assert p.send("PUT", q("/events/e1.json"))[0] == 405
    assert p.rows() == 0


def case_malformed_event_400(p, monkeypatch):
    assert p.send("POST", q("/events.json"), b"{not json")[0] == 400
    status, body, _ = p.send("POST", q("/events.json"),
                             json.dumps({"event": "rate"}).encode())
    assert status == 400 and "entityType" in body["message"]
    status, body, _ = p.send("POST", q("/events.json"), ev(
        "$bogus", eid="m1"))
    assert status == 400
    assert p.rows() == 0


def case_allowed_events_enforcement(p, monkeypatch):
    status, body, _ = p.send("POST", q("/events.json", "limited"),
                             ev("rate", eid="l1"))
    assert status == 403 and "not allowed" in body["message"]
    assert p.send("POST", q("/events.json", "limited"),
                  ev("view", eid="l2"))[0] == 201
    assert p.rows() == 1


def case_get_events_filters_and_limit(p, monkeypatch):
    for n in range(25):
        assert p.send("POST", q("/events.json"), ev(
            "rate", f"u{n}", eid=f"g{n}",
            eventTime=f"2021-01-01T00:{n:02d}:00.000Z"))[0] == 201
    status, body, _ = p.send("GET", q("/events.json"))
    assert status == 200 and len(body) == 20       # default limit
    assert len(p.send("GET", q("/events.json", limit="-1"))[1]) == 25
    status, body, _ = p.send("GET", q("/events.json", entityId="u3",
                                      entityType="user"))
    assert len(body) == 1 and body[0]["entityId"] == "u3"
    status, body, _ = p.send("GET", q(
        "/events.json", startTime="2021-01-01T00:10:00.000Z",
        untilTime="2021-01-01T00:12:00.000Z"))
    assert [e["entityId"] for e in body] == ["u10", "u11"]
    assert p.send("GET", q("/events.json", entityId="zzz",
                           entityType="user"))[0] == 404
    assert p.send("GET", q("/events.json", reversed="true"))[0] == 400
    assert p.send("GET", q("/events.json", reversed="true",
                           entityType="user", entityId="u3"))[0] == 200
    assert p.send("GET", q("/events.json", reversed="maybe"))[0] == 400
    assert p.send("GET", q("/events.json", event="rate", limit="3",
                           reversed="true", entityType="user",
                           entityId="u7"))[0] == 200
    assert p.rows() == 25


def _batch(n, prefix="b", name="rate"):
    return [json.loads(ev(name, f"x{k}", eid=f"{prefix}{k}"))
            for k in range(n)]


def case_batch_events(p, monkeypatch):
    items = [json.loads(ev("rate", "a", eid="b1")), {"event": "rate"},
             json.loads(ev("buy", "b", eid="b2"))]
    status, results, _ = p.send("POST", q("/batch/events.json"),
                                json.dumps(items).encode())
    assert status == 200
    assert [r["status"] for r in results] == [201, 400, 201]
    status, body, _ = p.send("POST", q("/batch/events.json"),
                             json.dumps(_batch(51, "c")).encode())
    assert status == 400 and "50" in body["message"]
    assert p.send("POST", q("/batch/events.json"), b'{"event": 1}')[0] == 400
    status, results, _ = p.send("POST", q("/batch/events.json", "limited"),
                                json.dumps(_batch(2, "d")).encode())
    assert [r["status"] for r in results] == [403, 403]
    assert p.rows() == 2


def case_batch_cap_configurable(p, monkeypatch):
    body = json.dumps(_batch(51)).encode()
    monkeypatch.setenv("PIO_BATCH_EVENTS_MAX", "100")
    status, results, _ = p.send("POST", q("/batch/events.json"), body)
    assert status == 200 and len(results) == 51
    assert all(r["status"] == 201 for r in results)
    monkeypatch.setenv("PIO_BATCH_EVENTS_MAX", "2")
    status, payload, _ = p.send("POST", q("/batch/events.json"),
                                json.dumps(_batch(3, "y")).encode())
    assert status == 400 and "2" in payload["message"]
    monkeypatch.setenv("PIO_BATCH_EVENTS_MAX", "junk")
    status, payload, _ = p.send("POST", q("/batch/events.json"), body)
    assert status == 400 and "50" in payload["message"]
    assert p.rows() == 51


def case_batch_bulk_and_per_item_paths_agree(p, monkeypatch):
    def items(tag):
        return json.dumps([json.loads(ev("rate", "a", eid=f"{tag}1")),
                           {"event": "rate"},
                           json.loads(ev("buy", "b", eid=f"{tag}2"))]
                          ).encode()
    status, bulk, _ = p.send("POST", q("/batch/events.json"), items("k"))
    monkeypatch.setenv("PIO_BATCH_BULK_INSERT", "0")
    status2, per_item, _ = p.send("POST", q("/batch/events.json"),
                                  items("p"))
    assert status == status2 == 200
    assert [r["status"] for r in bulk] == [r["status"] for r in per_item] \
        == [201, 400, 201]
    assert p.rows() == 4


def case_channel_auth_and_separation(p, monkeypatch):
    status, body, _ = p.send("POST", q("/events.json", channel="nope"),
                             ev(eid="c0"))
    assert status == 401 and "Invalid channel" in body["message"]
    assert p.send("POST", q("/events.json", channel="mobile"),
                  ev("tap", "u9", eid="c1"))[0] == 201
    assert p.send("GET", q("/events.json"))[0] == 404
    status, body, _ = p.send("GET", q("/events.json", channel="mobile"))
    assert len(body) == 1 and body[0]["event"] == "tap"
    assert p.send("GET", q("/events/c1.json"))[0] == 404
    assert p.send("GET", q("/events/c1.json", channel="mobile"))[0] == 200
    assert p.rows() == 0


def case_stats_route(p, monkeypatch):
    for mod in (ref_stats, stats):
        monkeypatch.setattr(mod, "utcnow", lambda: FROZEN)
    status, body, _ = p.send("GET", q("/stats.json"))
    assert status == 404 and "--stats" in body["message"]
    p.build(stats_on=True)
    assert p.send("POST", q("/events.json"), ev(eid="s1"))[0] == 201
    assert p.send("POST", q("/batch/events.json"), json.dumps(
        _batch(2, "t") + [{"event": "x"}]).encode())[0] == 200
    status, snap, _ = p.send("GET", q("/stats.json"))
    assert status == 200
    assert snap["longLive"]["basic"] == [{"key": {
        "entityType": "user", "targetEntityType": None, "event": "rate"},
        "value": 3}]
    assert snap["longLive"]["statusCode"] == [{"key": 201, "value": 3}]
    assert p.rows() == 3


def case_webhooks_segmentio(p, monkeypatch):
    payload = {"version": "2", "type": "track", "user_id": "alice",
               "event": "Signed Up", "properties": {"plan": "Pro"},
               "timestamp": "2021-03-04T05:06:07.000Z"}
    status, ref_body, body = p.send(
        "POST", q("/webhooks/segmentio.json"), json.dumps(payload).encode(),
        mask=WEBHOOK_MASK)
    assert status == 201
    status, got, _ = p.send(
        "GET", q(f"/events/{ref_body['eventId']}.json"), mask=WEBHOOK_MASK,
        port_target=q(f"/events/{body['eventId']}.json"))
    assert got["event"] == "track" and got["entityId"] == "alice"
    assert got["properties"]["event"] == "Signed Up"
    assert got["eventTime"] == "2021-03-04T05:06:07.000Z"
    assert p.send("GET", q("/webhooks/segmentio.json"))[0] == 200
    assert p.send("GET", q("/webhooks/nope.json"))[0] == 404
    assert p.send("POST", q("/webhooks/nope.json"), b"{}")[0] == 404
    assert p.send("POST", q("/webhooks/segmentio.json"),
                  json.dumps({"version": "2"}).encode())[0] == 400
    assert p.send("DELETE", q("/webhooks/segmentio.json"))[0] == 405
    assert p.rows(mask=WEBHOOK_MASK) == 1


def case_webhooks_mailchimp_form(p, monkeypatch):
    form = {
        "type": "subscribe", "fired_at": "2009-03-26 21:35:57",
        "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
        "data[email]": "api@mailchimp.com", "data[email_type]": "html",
        "data[merges][EMAIL]": "api@mailchimp.com",
        "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
        "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30",
    }
    status, ref_out, out = p.send(
        "POST", q("/webhooks/mailchimp.form"),
        urllib.parse.urlencode(form).encode(), mask=WEBHOOK_MASK)
    assert status == 201
    _, got, _ = p.send(
        "GET", q(f"/events/{ref_out['eventId']}.json"), mask=WEBHOOK_MASK,
        port_target=q(f"/events/{out['eventId']}.json"))
    assert got["event"] == "subscribe"
    assert got["targetEntityId"] == "a6b5da1054"
    assert got["eventTime"] == "2009-03-26T21:35:57.000Z"
    assert p.send("GET", q("/webhooks/mailchimp.form"))[0] == 200
    assert p.send("GET", q("/webhooks/nope.form"))[0] == 404
    assert p.send("POST", q("/webhooks/mailchimp.form"),
                  b"type=unknown")[0] == 400
    assert p.rows(mask=WEBHOOK_MASK) == 1


def case_plugins_describe_and_blocker(p, monkeypatch):
    p.build(plugins=[Blocker()])
    status, desc, _ = p.send("GET", "/plugins.json")
    assert "strict" in desc["plugins"]["inputblockers"]
    assert p.send("POST", q("/events.json"), ev("buy", eid="p1"))[0] == 500
    assert p.send("POST", q("/events.json"), ev("view", eid="p2"))[0] == 201
    status, results, _ = p.send("POST", q("/batch/events.json"), json.dumps(
        [json.loads(ev("buy", eid="p3")), json.loads(ev(eid="p4"))]).encode())
    assert [r["status"] for r in results] == [500, 201]
    assert p.send("GET", q("/plugins/inputblocker/strict/a/b"))[:2] == \
        (200, {"args": ["a", "b"]})
    assert p.send("GET", q("/plugins/inputblocker/none/a"))[0] == 404
    assert p.send("GET", q("/plugins/x"))[0] == 404
    assert p.rows() == 2


def case_readyz_while_draining(p, monkeypatch):
    p.ref.draining = p.port.draining = True
    assert p.send("GET", "/readyz")[:2] == (503, {"status": "draining"})


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_answers_and_rows_as_the_reference(name, monkeypatch):
    for var in ("PIO_BATCH_EVENTS_MAX", "PIO_BATCH_BULK_INSERT"):
        monkeypatch.delenv(var, raising=False)
    CASES[name](Pair(), monkeypatch)


@pytest.mark.parametrize("route", ["/metrics", "/traces.json"])
def test_telemetry_routes_are_the_documented_difference(route):
    """The event server's telemetry routes, which answered 404 before the
    port had a telemetry layer, now answer as the reference's: the same
    status and content type, the stats book's exposition lines byte for
    byte after the same ingest, and the same empty span ring."""
    from predictionio_tpu.common import tracing as ref_tracing
    from predictionio_tpu_torch.common import tracing

    p = Pair()
    p.build(stats_on=True)
    assert p.send("POST", q("/events.json"), ev(eid="m1"))[0] == 201
    assert p.send("POST", q("/events.json"), b"{not json")[0] == 400
    ref_tracing.clear()
    tracing.clear()
    ref = ref_dispatch(p.ref, "GET", route, b"", {})
    got = dispatch_request(p.port, "GET", route, b"", {})
    status, data, ctype = got.status, got.data, got.ctype
    assert (status, ctype) == (ref.status, ref.ctype)
    assert status == 200
    if route == "/traces.json":
        assert data == ref.data
        assert json.loads(data)["traces"] == []
    else:
        book = p.port.stats.collect_metrics()
        assert book == p.ref.stats.collect_metrics()
        assert 'pio_events_ingested_total{app_id="' in book[-1]
        lines = data.decode().splitlines()
        assert all(line in lines for line in book)
    # the metrics history answers as the reference's: the same status,
    # content type and keys
    ref = ref_dispatch(p.ref, "GET", "/debug/history.json", b"", {})
    got = dispatch_request(p.port, "GET", "/debug/history.json", b"", {})
    assert (got.status, got.ctype) == (ref.status, ref.ctype)
    assert got.status == 200
    assert sorted(json.loads(got.data)) == sorted(json.loads(ref.data))


def _wire(port, method, target, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{target}",
                                 data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]


def test_http_transport_smoke():
    """Both servers through ``serve_background`` on real sockets: the same
    bytes for the same requests."""
    p = Pair()
    ref_server, ref_port = ref_serve(p.ref, "127.0.0.1")
    server, port = serve_background(p.port, "127.0.0.1")
    try:
        for method, target, body in [
                ("GET", "/", None),
                ("POST", q("/events.json"), ev(eid="w1")),
                ("GET", q("/events/w1.json"), None),
                ("GET", "/events.json", None),
                ("DELETE", q("/events/w1.json"), None),
                ("DELETE", q("/events/w1.json"), None)]:
            assert _wire(port, method, target, body) == \
                _wire(ref_port, method, target, body), (method, target)
    finally:
        ref_server.shutdown()
        server.shutdown()
        server.server_close()
