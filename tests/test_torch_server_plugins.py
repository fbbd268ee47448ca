"""Engine-server plugins and prediction feedback on the port
(``workflow/server_plugins.py``, ``QueryAPI``): an output blocker's
rewrite reaches the answer as in the reference's server, an output
sniffer sees every answered query off the serving path, ``/plugins.json``
and the
``/plugins/<type>/<name>/...`` handoff answer as the reference's, and
``--feedback`` posts one ``predict`` event per query to a port event
server's store. Every server binds port 0."""

import json
import threading

import pytest

from predictionio_tpu.workflow import create_server as jserver
from predictionio_tpu.workflow import server_plugins as ref_plugins
from predictionio_tpu_torch.data.api import EventAPI
from predictionio_tpu_torch.data.storage import AccessKey, App, Storage
from predictionio_tpu_torch.workflow import server_plugins

import torch_deploy_util as util
import torch_fleet_util as fleet


@pytest.fixture(autouse=True)
def _int8(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")


def _plugins(mod):
    """A blocker that keeps the first two items and tags the answer, and
    a sniffer that records what it saw, on one package's plugin SPI."""
    class Top2(mod.EngineServerPlugin):
        plugin_name = "top2"
        plugin_description = "keeps the first two items"
        plugin_type = mod.OUTPUT_BLOCKER

        def process(self, engine_instance, query_obj, prediction_obj,
                    context):
            return {**prediction_obj,
                    "itemScores": prediction_obj["itemScores"][:2],
                    "blockedFor": query_obj["user"]}

        def handle_rest(self, args):
            return json.dumps({"args": list(args)})

    class Seen(mod.EngineServerPlugin):
        plugin_name = "seen"
        plugin_description = "records every answered query"
        plugin_type = mod.OUTPUT_SNIFFER

        def __init__(self):
            self.seen = []

        def process(self, engine_instance, query_obj, prediction_obj,
                    context):
            self.seen.append((query_obj["user"], prediction_obj))

        def handle_rest(self, args):
            return "plain text"

    return Top2(), Seen()


def _query_api_with(storage, plugin_context=None, **cfg):
    from predictionio_tpu_torch.workflow.create_server import (
        QueryAPI, ServerConfig,
    )
    return QueryAPI(storage=storage, plugin_context=plugin_context,
                    config=ServerConfig(device="cpu", serve_quant="on",
                                        batching="on",
                                        batch_max_delay_ms=1.0, **cfg))


def _deploy_both(blob):
    """Both packages' servers on ``blob`` with the same two plugins
    registered -> (reference api, port api, the port's sniffer)."""
    from predictionio_tpu.data.storage import Storage as JStorage
    js = JStorage(env=util.MEM)
    iid = js.get_meta_data_engine_instances().insert(util._instance(
        util.JEngineInstance,
        "predictionio_tpu.models.recommendation.engine:"
        "RecommendationEngine"))
    js.get_model_data_models().insert(util.JModel(iid, blob))
    ref_top, ref_seen = _plugins(ref_plugins)
    top, seen = _plugins(server_plugins)
    japi = jserver.QueryAPI(
        storage=js,
        plugin_context=ref_plugins.EngineServerPluginContext(
            [ref_top, ref_seen]),
        config=jserver.ServerConfig(serve_quant="on", aot="off",
                                    batching="on", batch_max_delay_ms=1.0))
    tapi = _query_api_with(
        fleet.store_with(blob),
        server_plugins.EngineServerPluginContext([top, seen]))
    return japi, tapi, seen


@pytest.mark.parametrize("user,num", [("u3", 4), ("u0", 40), ("u7", 1)])
def test_a_blocker_rewrites_and_a_sniffer_sees_as_the_reference(user, num):
    japi, tapi, seen = _deploy_both(util.dyadic_blob())
    try:
        body = util.query(user, num)
        want = japi.handle("POST", "/queries.json", body=body)
        got = tapi.handle("POST", "/queries.json", body=body)
        assert got[0] == want[0] == 200
        assert json.dumps(got[1]) == json.dumps(want[1])
        assert got[1]["blockedFor"] == user
        assert len(got[1]["itemScores"]) == min(num, 2)
        fleet.wait_for(lambda: len(seen.seen) == 1)
        assert seen.seen == [(user, got[1])]
    finally:
        japi.close()
        tapi.close()


@pytest.mark.parametrize("method,path", [
    ("GET", "/plugins.json"), ("GET", "/plugins/outputblocker/top2/a/b"),
    ("GET", "/plugins/outputsniffer/seen"), ("GET", "/plugins/nope/x"),
    ("GET", "/plugins/outputblocker")])
def test_the_plugin_routes_answer_as_the_reference(method, path):
    japi, tapi, _ = _deploy_both(util.dyadic_blob())
    try:
        want = japi.handle(method, path)
        got = tapi.handle(method, path)
        if path == "/plugins.json":
            # the class paths name each package's own test module
            for block in (got[1], want[1]):
                for kind in block["plugins"].values():
                    for entry in kind.values():
                        entry.pop("class")
        assert got == want
    finally:
        japi.close()
        tapi.close()


def test_a_sniffer_that_raises_does_not_fail_the_query():
    class Broken(server_plugins.EngineServerPlugin):
        plugin_name = "broken"
        plugin_type = server_plugins.OUTPUT_SNIFFER

        def process(self, *args):
            raise RuntimeError("sniffer bug")

    storage = fleet.store_with(util.dyadic_blob())
    api = _query_api_with(
        storage, server_plugins.EngineServerPluginContext([Broken()]))
    try:
        assert api.handle("POST", "/queries.json",
                          body=util.query("u1", 3))[0] == 200
    finally:
        api.close()


def test_a_slow_sniffer_holds_no_query():
    """Sniffers run on their own thread: while one is blocked, queries are
    answered, and it then sees each of them in order."""
    release = threading.Event()
    seen = []

    class Slow(server_plugins.EngineServerPlugin):
        plugin_name = "slow"
        plugin_type = server_plugins.OUTPUT_SNIFFER

        def process(self, inst, query_obj, prediction, ctx):
            release.wait(timeout=30)
            seen.append(query_obj["user"])

    storage = fleet.store_with(util.dyadic_blob())
    api = _query_api_with(
        storage, server_plugins.EngineServerPluginContext([Slow()]))
    try:
        users = ["u1", "u2", "u5"]
        for user in users:
            assert api.handle("POST", "/queries.json",
                              body=util.query(user, 3))[0] == 200
        assert seen == []
        release.set()
        fleet.wait_for(lambda: len(seen) == len(users))
        assert seen == users
    finally:
        release.set()
        api.close()


def test_feedback_posts_one_predict_event_per_query():
    """``feedback`` on: each answered query becomes a ``predict`` event of
    entity type ``pio_pr`` in the event server's store, carrying the
    instance id, the query and the answer."""
    es_store = Storage(env=util.MEM)
    app_id = es_store.get_meta_data_apps().insert(App(0, "FeedApp", None))
    es_store.get_events().init(app_id)
    es_store.get_meta_data_access_keys().insert(
        AccessKey("fb-key", app_id, ()))
    es = EventAPI(storage=es_store)
    es_server, es_port = fleet.serve(es)
    storage = fleet.store_with(util.dyadic_blob())
    api = _query_api_with(storage, feedback=True,
                          event_server_ip="127.0.0.1",
                          event_server_port=es_port, access_key="fb-key")
    try:
        answers = {}
        for user in ("u1", "u2", "u5"):
            status, answer = api.handle("POST", "/queries.json",
                                        body=util.query(user, 3))
            assert status == 200
            answers[user] = answer

        def stored():
            return list(es_store.get_events().find(
                app_id, event_names=["predict"]))

        fleet.wait_for(lambda: len(stored()) == 3)
        events = stored()
        assert {e.entity_type for e in events} == {"pio_pr"}
        assert len({e.entity_id for e in events}) == 3
        by_user = {e.properties.get("query")["user"]: e for e in events}
        assert set(by_user) == set(answers)
        for user, e in by_user.items():
            assert e.properties.get("prediction") == answers[user]
            assert e.properties.get("engineInstanceId") == \
                api.engine_instance.id
    finally:
        api.close()
        fleet.stop(es_server)


def test_the_plugin_context_is_empty_by_default():
    storage = fleet.store_with(util.dyadic_blob())
    api = _query_api_with(storage)
    try:
        assert api.handle("GET", "/plugins.json") == (200, {"plugins": {
            "outputblockers": {}, "outputsniffers": {}}})
    finally:
        api.close()


def test_blockers_run_in_registration_order_on_every_query():
    calls = []
    lock = threading.Lock()

    def blocker(tag):
        class B(server_plugins.EngineServerPlugin):
            plugin_name = tag
            plugin_type = server_plugins.OUTPUT_BLOCKER

            def process(self, inst, query_obj, prediction, ctx):
                with lock:
                    calls.append(tag)
                return {**prediction, "order": prediction.get("order", "")
                        + tag}
        return B()

    storage = fleet.store_with(util.dyadic_blob())
    api = _query_api_with(storage, server_plugins.EngineServerPluginContext(
        [blocker("x"), blocker("y")]))
    try:
        for _ in range(3):
            status, got = api.handle("POST", "/queries.json",
                                     body=util.query("u1", 2))
            assert status == 200 and got["order"] == "xy"
        assert calls == ["x", "y"] * 3
    finally:
        api.close()
