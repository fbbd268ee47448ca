"""Continuous training (``workflow/autotrain.py``) in the port against the
JAX package's, on the CPU.

- The control loop: the same ``Signals`` sequences (a fake clock, a fake
  trainer and a fake serving control) through both packages'
  ``Autotrain.tick`` give the same decisions, the same journal entries
  with their evidence, the same phases and the same ``summary()``: the
  trigger order drift > lag > volume > staleness, per-class cooldowns
  charged at decision time, the one-retrain-in-flight guard, hold-off
  under skew or a running reload (journaled once an edge), the one
  crash-resume, the publish that waits out a hold-off, and the dry run.
- The gates: ``validate_candidate`` over the same stored factor models
  (a clone, a seeded-worse candidate, a perturbed one, one over a
  smaller vocabulary) in a memory, a SQLite and an eventlog store gives
  equal verdict dicts; ``ranking_agreement`` is bit-equal.
- An accept cycle (a real retrain on the loop's thread) and a reject
  cycle through an in-process port deploy: the answers after the cycle
  equal a dense numpy golden of the int8 path on the generation that
  serves.
- The CLI parses every new flag, and the doctor reads the port's
  ``autotrain`` block as the reference's doctor does.

Nothing here sleeps on a clock: ticks are driven by hand and every
thread is joined.
"""

import dataclasses
import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.common import journal as jjournal
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import EngineInstance as JEngineInstance
from predictionio_tpu.data.storage import Model as JModel
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.models.recommendation.engine import (
    RecommendationEngine as JRecommendationEngine,
)
from predictionio_tpu.ops import quant as jquant
from predictionio_tpu.tools import doctor as jdoctor
from predictionio_tpu.workflow import autotrain as jautotrain
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.common import journal
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    App, EngineInstance, Model, Storage,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    RecommendationEngine,
)
from predictionio_tpu_torch.ops import quant
from predictionio_tpu_torch.tools import cli, doctor
from predictionio_tpu_torch.workflow import autotrain, create_server
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train

import torch_deploy_util as util

APP = "AutoApp"
N_USERS, N_ITEMS, RANK = 40, 30, 4
T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
SIDES = {"ref": (jautotrain, jjournal), "port": (autotrain, journal)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("PIO_FOLDIN_DRIFT_RECALL_MIN", "PIO_TORCH_DEVICE",
                 "PIO_TRAIN_STREAM", "PIO_FOLDIN", "PIO_AOT"):
        monkeypatch.delenv(name, raising=False)
    for name in [n for n in __import__("os").environ
                 if n.startswith("PIO_AUTOTRAIN_")]:
        monkeypatch.delenv(name)
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    jjournal.clear()
    journal.clear()
    yield
    jjournal.clear()
    journal.clear()


def _cfg(mod, **kw):
    kw.setdefault("poll_ms", 50.0)
    kw.setdefault("cooldown_s", 30.0)
    kw.setdefault("max_staleness_s", 3600.0)
    kw.setdefault("volume_events", 10)
    kw.setdefault("lag_events", 10)
    kw.setdefault("tolerance", 0.02)
    kw.setdefault("parity_min", 0.2)
    kw.setdefault("probe", 64)
    kw.setdefault("publish_timeout_s", 10.0)
    return mod.AutotrainConfig(**kw)


def _fakes(mod):
    """A serving stand-in whose publish bumps the generation, and a
    trainer whose attempts pop results from a list."""

    class FakeControl(mod.ServerControl):
        def __init__(self):
            self._status = {"generation": 1, "generationSkew": False,
                            "reload": {"active": False}}
            self.publishes = 0

        def status(self):
            return dict(self._status)

        def publish(self):
            self.publishes += 1
            self._status["generation"] += 1

    class FakeTrainer(mod.Trainer):
        def __init__(self, results=()):
            self.started = 0
            self.results = list(results)
            self._live = None

        def start(self):
            self.started += 1
            self._live = self.results.pop(0) if self.results else None

        @property
        def running(self):
            return False

        def poll(self):
            return self._live

    return FakeControl, FakeTrainer


def _events(jr):
    return [(e["level"], e["category"], e["message"], e["fields"])
            for e in jr.snapshot(category="autotrain")["events"]]


def _summary(at):
    s = at.summary()
    if s["lastDecision"] is not None:
        s["lastDecision"] = {k: v for k, v in s["lastDecision"].items()
                             if k not in ("at", "ageS")}
    return s


#: each scenario: (config overrides, trainer results, steps); a step is
#: the Signals' fields, or a string naming a poke between ticks
SCENARIOS = {
    "staleness_then_cooldown": ({}, [], [
        dict(staleness_s=4000.0), "idle", dict(now=1010.0,
                                               staleness_s=4000.0),
        dict(now=1031.0, staleness_s=4000.0)]),
    "drift_wins_with_evidence": ({}, [], [
        dict(drift=0.5, item_drift=0.4, cursor_lag=999, volume=999,
             staleness_s=99999.0)]),
    "item_drift_alone": ({}, [], [dict(item_drift=0.3)]),
    "lag_before_volume": ({}, [], [dict(cursor_lag=25, volume=25)]),
    "volume_then_under_threshold": ({}, [], [
        dict(volume=25), "idle", dict(now=1001.0, volume=5),
        dict(now=1040.0, volume=5)]),
    "one_retrain_in_flight": ({}, [], [
        dict(staleness_s=4000.0),
        dict(now=2000.0, drift=0.1, cursor_lag=999, volume=999,
             staleness_s=99999.0)]),
    "holdoff_edges": ({}, [], [
        dict(generation_skew=True, staleness_s=9999.0),
        dict(now=1001.0, generation_skew=True, staleness_s=9999.0),
        dict(now=1001.5, reload_active=True),
        dict(now=1002.0)]),
    "crash_resume_once_then_fail": ({}, [
        {"ok": False, "error": "boom 1"},
        {"ok": False, "error": "boom 2"}], [
        dict(staleness_s=9999.0), dict(now=1001.0), dict(now=1002.0)]),
    "crash_resume_then_no_candidate": ({}, [
        {"ok": False, "error": "boom"}, {"ok": True, "instanceId": "L"}], [
        dict(volume=50, live_instance_id="L"), dict(now=1001.0),
        dict(now=1002.0)]),
    "dry_run": ({"dry_run": True}, [], [
        dict(volume=999), dict(now=1001.0, volume=999),
        dict(now=1031.0, staleness_s=99999.0, volume=999)]),
}


def _run_scenario(side, name):
    mod, jr = SIDES[side]
    jr.clear()
    cfg, results, steps = SCENARIOS[name]
    FakeControl, FakeTrainer = _fakes(mod)
    control, trainer = FakeControl(), FakeTrainer(results)
    at = mod.Autotrain(control, storage=None, trainer=trainer,
                       config=_cfg(mod, **cfg))
    at._live_id = "L"
    trace = []
    for step in steps:
        if step == "idle":
            at._phase = "idle"
            continue
        step = dict(step)
        step.setdefault("now", 1000.0)
        acted = at.tick(mod.Signals(**step))
        trace.append(([{k: v for k, v in a.items() if k != "at"}
                       for a in acted], at._phase, at._holdoff,
                      trainer.started, control.publishes))
    return trace, _events(jr), _summary(at)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tick_decides_as_the_reference(name):
    want = _run_scenario("ref", name)
    got = _run_scenario("port", name)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[1], "the scenario journaled nothing"


def test_config_reads_the_same_env(monkeypatch):
    values = {"POLL_MS": "25", "COOLDOWN_S": "7", "MAX_STALENESS_S": "90",
              "VOLUME_EVENTS": "123", "LAG_EVENTS": "45",
              "TOLERANCE": "0.1", "PARITY_MIN": "0.5", "PROBE": "32",
              "PUBLISH_TIMEOUT_S": "12"}
    for k, v in values.items():
        monkeypatch.setenv(f"PIO_AUTOTRAIN_{k}", v)
    got = dataclasses.asdict(autotrain.AutotrainConfig().resolved())
    want = dataclasses.asdict(jautotrain.AutotrainConfig().resolved())
    assert got == want
    assert got["volume_events"] == 123 and got["tolerance"] == 0.1


def test_ranking_agreement_is_bit_equal():
    rng = np.random.default_rng(5)
    Ua, Va = rng.normal(size=(50, 6)), rng.normal(size=(35, 6))
    Ub = Ua + 0.3 * rng.normal(size=Ua.shape)
    Vb = Va + 0.3 * rng.normal(size=Va.shape)
    umap = rng.permutation(50)[:40]
    imap = rng.permutation(35)[:30]
    for kw in ({}, {"k": 5, "sample": 17}, {"user_map": umap,
                                            "item_map": imap, "k": 50},
               {"user_map": np.empty(0, np.int64)}):
        want = jquant.ranking_agreement(Ua, Va, Ub, Vb, **kw)
        got = quant.ranking_agreement(Ua, Va, Ub, Vb, **kw)
        assert got == want, kw
    assert quant.ranking_agreement(Ua, Va, Ua, Va)["recall"] == 1.0


# ---------------------------------------------------------------------------
# the gates over stored factor models
# ---------------------------------------------------------------------------

def _factors(seed, n_users=N_USERS, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, RANK)).astype(np.float32),
            rng.normal(size=(n_items, RANK)).astype(np.float32))


def _blob(U, V, users=None, items=None):
    users = users if users is not None else [f"u{i}" for i in
                                             range(U.shape[0])]
    items = items if items is not None else [f"i{i}" for i in
                                             range(V.shape[0])]
    return jmodel_io.serialize_models([JALSModel(
        rank=RANK, user_factors=U, item_factors=V,
        user_vocab=JBiMap.string_int(users),
        item_vocab=JBiMap.string_int(items))])


def _candidates():
    U, V = _factors(1)
    rng = np.random.default_rng(2)
    keep_u = sorted(rng.choice(N_USERS, size=25, replace=False))
    keep_i = sorted(rng.choice(N_ITEMS, size=20, replace=False))
    return {
        "live": _blob(U, V),
        "clone": _blob(U, V),
        "worse": _blob(-U, V),
        "perturbed": _blob(U + 0.2 * rng.normal(size=U.shape).astype(
            np.float32), V),
        "subset": _blob(U[keep_u][::-1].copy(), V[keep_i].copy(),
                        users=[f"u{i}" for i in keep_u][::-1],
                        items=[f"i{i}" for i in keep_i]),
    }


def _stores(kind, tmp_path):
    if kind == "memory":
        return JStorage(env=util.MEM), Storage(env=util.MEM)
    if kind == "sqlite":
        return (JStorage(env={"PIO_FS_BASEDIR": str(tmp_path / "jsql")}),
                Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "tsql")}))

    def env(name):
        return {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
                "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / name),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}
    return JStorage(env=env("jel")), Storage(env=env("tel"))


def _rating_events(cls, dm, trainable=False):
    """Rates (some half-stars, some outside the vocabularies), buys, a
    view and, unless ``trainable``, rates without a rating; whole
    seconds."""
    rng = np.random.default_rng(9)
    out = []
    for k in range(300):
        name = "buy" if k % 7 == 0 else ("view" if k % 53 == 0 else "rate")
        unrated = k % 41 == 0 and not trainable
        props = {} if name != "rate" or unrated else {
            "rating": float(rng.integers(1, 11)) / 2}
        out.append(cls(
            event=name, entity_type="user",
            entity_id=f"u{int(rng.integers(N_USERS + 5))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(N_ITEMS + 3))}",
            properties=dm(props),
            event_time=T0 + dt.timedelta(seconds=int(rng.integers(200)))))
    return out


def _fill(storage, port: bool, blobs) -> dict:
    app_cls, inst_cls, model_cls = ((App, EngineInstance, Model) if port
                                    else (JApp, JEngineInstance, JModel))
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP, None))
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch(_rating_events(*((Event, DataMap) if port
                                         else (JEvent, JDataMap))), app_id)
    ids = {}
    for name, blob in blobs.items():
        iid = storage.get_meta_data_engine_instances().insert(
            util._instance(inst_cls, "x"))
        storage.get_model_data_models().insert(model_cls(iid, blob))
        ids[name] = iid
    return ids


def _engine_params(port: bool):
    variant = {"datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "als", "params": {
                   "rank": RANK, "numIterations": 2, "lambda": 0.05,
                   "seed": 3}}]}
    engine = RecommendationEngine() if port else JRecommendationEngine()
    return engine.engine_params_from_json(variant)


@pytest.mark.parametrize("kind", ["memory", "sqlite", "eventlog"])
def test_validate_candidate_gives_the_references_verdicts(kind, tmp_path):
    blobs = _candidates()
    jstorage, tstorage = _stores(kind, tmp_path)
    jids, tids = _fill(jstorage, False, blobs), _fill(tstorage, True, blobs)
    jep, tep = _engine_params(False), _engine_params(True)
    verdicts = {}
    for cand in ("clone", "worse", "perturbed", "subset"):
        for sample, k in ((64, 10), (500, 3)):
            want = jautotrain.validate_candidate(
                jstorage, jep, jids["live"], jids[cand], sample=sample, k=k)
            got = autotrain.validate_candidate(
                tstorage, tep, tids["live"], tids[cand], sample=sample, k=k)
            for v, ids in ((want, jids), (got, tids)):
                assert v.pop("candidateId") == ids[cand]
                assert v.pop("liveId") == ids["live"]
            assert got == want, (cand, sample)
            verdicts[cand, sample] = got
    assert verdicts["clone", 64]["ok"]
    assert verdicts["clone", 64]["parity"]["recall"] == 1.0
    assert not verdicts["worse", 64]["ok"]
    assert verdicts["worse", 64]["reasons"]
    assert verdicts["subset", 500]["parity"]["commonItems"] == 20
    assert verdicts["clone", 500]["score"]["probeTriples"] > 64


@pytest.mark.parametrize("cand", ["clone", "worse"])
def test_a_validated_cycle_waits_out_a_hold_off_as_the_reference(cand):
    """A candidate through the gates while a reload barrier runs: the
    accepted one publishes only once the barrier is over, the rejected
    one never; both packages journal the same cycle."""
    blobs = _candidates()
    out = {}
    for side, port in (("ref", False), ("port", True)):
        mod, jr = SIDES[side]
        jr.clear()
        storage = Storage(env=util.MEM) if port else JStorage(env=util.MEM)
        ids = _fill(storage, port, blobs)
        FakeControl, FakeTrainer = _fakes(mod)
        control = FakeControl()
        at = mod.Autotrain(
            control, storage=storage, engine_params=_engine_params(port),
            trainer=FakeTrainer([{"ok": True, "instanceId": ids[cand]}]),
            config=_cfg(mod))
        at._live_id = ids["live"]
        trace = []
        for step in (dict(staleness_s=9999.0),
                     dict(now=1001.0, reload_active=True),
                     dict(now=1002.0)):
            at.tick(mod.Signals(**{"now": 1000.0, **step}))
            trace.append((at._phase, control.publishes,
                          storage.get_meta_data_engine_instances().get(
                              ids[cand]).status))
        names = {v: k for k, v in ids.items()}
        events = [(lvl, cat, msg.replace(ids[cand], "<cand>"),
                   {k: (names.get(v, v) if isinstance(v, str) else v)
                    for k, v in fields.items() if k != "cycleS"})
                  for lvl, cat, msg, fields in _events(jr)]
        out[side] = trace, [m for m in events
                            if "cycle" not in m[2]], _summary(at)
        for s in (out[side][2],):
            s.pop("lastCandidate")
            s.pop("lastCycle")
    assert out["port"] == out["ref"]
    want = ([("publishing", 0, "COMPLETED"), ("idle", 1, "COMPLETED")]
            if cand == "clone" else
            [("idle", 0, "REJECTED"), ("idle", 0, "REJECTED")])
    assert out["port"][0][1:] == want


def test_probe_triples_read_the_same_rows_on_every_store(tmp_path):
    """The port reads a store with a columnar read through it; the
    triples equal the reference's Event-object read."""
    for kind in ("sqlite", "eventlog"):
        jstorage, tstorage = _stores(kind, tmp_path / kind)
        _fill(jstorage, False, {})
        _fill(tstorage, True, {})
        for sample in (10, 1000):
            want = jautotrain._probe_triples(jstorage, _engine_params(False),
                                             sample)
            got = autotrain._probe_triples(tstorage, _engine_params(True),
                                           sample)
            assert [(u, i, np.float32(r)) for u, i, r in got] == \
                [(u, i, np.float32(r)) for u, i, r in want], kind
            assert len(got) == min(sample, len(want)) > 0


def test_validate_skips_are_explicit():
    for mod, store in ((jautotrain, JStorage(env=util.MEM)),
                       (autotrain, Storage(env=util.MEM))):
        v = mod.validate_candidate(store, None, None, "ghost")
        assert not v["ok"] and "no model blob" in v["reasons"][0]
    tstore = Storage(env=util.MEM)
    tstore.get_model_data_models().insert(
        Model("c1", jmodel_io.serialize_models([{"not": "factors"}])))
    v = autotrain.validate_candidate(tstore, None, None, "c1")
    assert v["ok"] and "skipped" in v["score"] and "skipped" in v["parity"]


def test_mark_rejected_hides_the_row_from_every_resolve():
    tstore = Storage(env=util.MEM)
    ids = _fill(tstore, True, {"live": _candidates()["live"]})
    newer = dataclasses.replace(util._instance(EngineInstance, "x"),
                                start_time=T0 + dt.timedelta(days=400))
    cand = tstore.get_meta_data_engine_instances().insert(newer)
    instances = tstore.get_meta_data_engine_instances()
    assert instances.get_latest_completed(
        "default", "NOT_USED", "default").id == cand
    autotrain.mark_rejected(tstore, cand)
    assert instances.get(cand).status == "REJECTED"
    assert instances.get_latest_completed(
        "default", "NOT_USED", "default").id == ids["live"]


# ---------------------------------------------------------------------------
# cycles through an in-process port deploy
# ---------------------------------------------------------------------------

PORT_FACTORY = ("predictionio_tpu_torch.models.recommendation.engine:"
                "RecommendationEngine")
VARIANT = {"id": "default", "engineFactory": PORT_FACTORY,
           "datasource": {"params": {"appName": APP}},
           "algorithms": [{"name": "als", "params": {
               "rank": RANK, "numIterations": 3, "lambda": 0.05,
               "seed": 3}}]}


def _golden(blob: bytes, user: str, num: int) -> dict:
    """The answer of the int8 path on a stored model, in numpy."""
    from predictionio_tpu_torch.workflow import model_io
    (m,) = model_io.deserialize_models(blob)
    uq, us = quant.quantize_rows(np.asarray(m.user_factors, np.float32))
    vq, vs = quant.quantize_rows(np.asarray(m.item_factors, np.float32))
    u = m.user_vocab(user)
    s32 = vq.astype(np.int32) @ uq[u].astype(np.int32)
    scores = s32.astype(np.float32) * (us[u] * vs)
    order = np.argsort(-scores, kind="stable")[:num]
    inv = m.item_vocab.inverse()
    return {"itemScores": [{"item": inv(int(i)), "score": float(scores[i])}
                           for i in order]}


def _answers(api, users):
    return {u: api.handle("POST", "/queries.json",
                          body=util.query(u, 5))[:2] for u in users}


def _deployed(tmp_path):
    store = Storage(env=util.MEM)
    app_id = store.get_meta_data_apps().insert(App(0, APP, None))
    store.get_events().init(app_id)
    store.get_events().insert_batch(
        _rating_events(Event, DataMap, trainable=True), app_id)
    engine = RecommendationEngine()
    live = run_train(WorkflowContext(storage=store, device="cpu"), engine,
                     engine.engine_params_from_json(VARIANT),
                     engine_factory=PORT_FACTORY, params_json=VARIANT)
    api = create_server.QueryAPI(
        storage=store, engine=engine,
        config=create_server.ServerConfig(device="cpu", serve_quant="on",
                                          batching="on",
                                          batch_max_delay_ms=1.0))
    return store, app_id, engine, live, api


def _drive(at, max_ticks=50):
    """Tick the loop on gathered signals until its cycle is over."""
    for _ in range(max_ticks):
        at.tick(at.gather())
        if at.trainer._thread is not None:
            at.trainer._thread.join(timeout=120)
        if at._phase == "idle" and at.summary()["lastCandidate"]:
            return
    raise AssertionError(f"the cycle did not finish: {at.summary()}")


def test_accept_cycle_retrains_validates_and_publishes(tmp_path):
    store, app_id, engine, live, api = _deployed(tmp_path)
    try:
        users = ["u0", "u3", "u17"]
        before = _answers(api, users)
        candidates = []

        def retrain():
            iid = run_train(
                WorkflowContext(storage=store, device="cpu"), api.engine,
                api.engine_params, engine_factory=PORT_FACTORY,
                params_json=VARIANT)
            candidates.append(iid)
            return iid

        at = autotrain.Autotrain(
            autotrain.LocalDeployControl(api), storage=store,
            engine_params=api.engine_params,
            trainer=autotrain.ThreadTrainer(retrain, device=api.device),
            config=_cfg(autotrain, volume_events=20))
        api.attach_autotrain(at)
        assert at.tick(at.gather()) == []        # nothing past the cursor
        store.get_events().insert_batch([Event(
            event="rate", entity_type="user", entity_id=f"u{j % 9}",
            target_entity_type="item", target_entity_id=f"i{j % 13}",
            properties=DataMap({"rating": 5.0}),
            event_time=T0 + dt.timedelta(hours=1, seconds=j))
            for j in range(25)], app_id)
        sig = at.gather()
        assert sig.volume == 25 and sig.live_instance_id == live
        (decision,) = at.tick(sig)
        assert decision["trigger"] == "volume"
        _drive(at)
        (cand,) = candidates
        assert api.generation == 2 and api.engine_instance.id == cand
        s = api.handle("GET", "/")[1]["autotrain"]
        assert s["lastCandidate"]["ok"] and s["lastCycle"]["generation"] == 2
        blob = store.get_model_data_models().get(cand).models
        after = _answers(api, users)
        for u in users:
            assert after[u] == (200, _golden(blob, u, 5)), u
        assert before != after
        # the doctor reads the block as the reference's doctor does
        scraped = {"url": "http://t",
                   "healthz": {"status": 200, "body": '{"status": "ok"}'},
                   "readyz": {"status": 200, "body": '{"status": "ok"}'},
                   "root": {"status": 200, "body": json.dumps(
                       {"autotrain": s})},
                   "metrics": {"status": 200, "body": ""},
                   "traces": {"status": 404, "body": ""},
                   "device": {"status": 200, "body": '{"telemetry": true}'}}
        line = next(c for c in doctor.diagnose(scraped)
                    if c[0] == "autotrain")
        assert line == next(c for c in jdoctor.diagnose(scraped)
                            if c[0] == "autotrain")
        assert line[1] == doctor.OK and "ACCEPTED" in line[2]
    finally:
        api.close()


def test_reject_cycle_keeps_the_generation_and_its_answers(tmp_path):
    store, _app_id, _engine, live, api = _deployed(tmp_path)
    try:
        users = ["u0", "u3", "u17", "u39"]
        before = _answers(api, users)
        live_blob = store.get_model_data_models().get(live).models
        (m,) = jmodel_io.deserialize_models(live_blob)
        worse = _blob(-np.asarray(m.user_factors, np.float32),
                      np.asarray(m.item_factors, np.float32),
                      users=list(m.user_vocab.to_dict()),
                      items=list(m.item_vocab.to_dict()))
        row = store.get_meta_data_engine_instances().get(live)
        cand = store.get_meta_data_engine_instances().insert(
            EngineInstance(**{**row.__dict__, "id": ""}))
        store.get_model_data_models().insert(Model(cand, worse))
        _FakeControl, FakeTrainer = _fakes(autotrain)
        at = autotrain.Autotrain(
            autotrain.LocalDeployControl(api), storage=store,
            engine_params=api.engine_params,
            trainer=FakeTrainer([{"ok": True, "instanceId": cand}]),
            config=_cfg(autotrain))
        at._live_id = live
        at.tick(autotrain.Signals(now=1000.0, staleness_s=99999.0,
                                  live_instance_id=live))
        at.tick(autotrain.Signals(now=1001.0))
        assert at._phase == "idle"
        assert store.get_meta_data_engine_instances().get(cand).status \
            == "REJECTED"
        assert api.generation == 1 and api.engine_instance.id == live
        assert _answers(api, users) == before
        for u in users:
            assert before[u] == (200, _golden(live_blob, u, 5)), u
        api._reload()                      # no resolve picks it up
        assert api.engine_instance.id == live
        s = at.summary()
        assert s["candidatesRejected"] == 1 and not s["lastCandidate"]["ok"]
    finally:
        api.close()


def test_status_has_no_autotrain_block_until_attached():
    japi, tapi = util.deploy_both(util.dyadic_blob())
    try:
        assert "autotrain" not in tapi.handle("GET", "/")[1]
        assert "autotrain" not in japi.handle("GET", "/")[1]
        at = autotrain.Autotrain(autotrain.LocalDeployControl(tapi),
                                 storage=tapi.storage,
                                 config=_cfg(autotrain, dry_run=True))
        tapi.attach_autotrain(at)
        assert tapi.handle("GET", "/")[1]["autotrain"]["mode"] == "dry-run"
    finally:
        japi.close()
        tapi.close()


def test_run_loop_stops_and_journals_one_warning_a_streak():
    class Failing(autotrain.ServerControl):
        calls = 0

        def status(self):
            Failing.calls += 1
            if Failing.calls >= 3:
                at.stop()
            raise RuntimeError("server restarting")

        def publish(self):
            pass

    at = autotrain.Autotrain(Failing(), storage=None,
                             config=_cfg(autotrain, poll_ms=1.0))
    at.run()
    warns = [e for e in journal.snapshot(level="warn")["events"]
             if e["category"] == "autotrain"
             and "signal gather failed" in e["message"]]
    assert Failing.calls == 3 and len(warns) == 1


def test_cli_parses_every_autotrain_and_autopilot_flag():
    p = cli.build_parser()
    a = p.parse_args(["autotrain", "--server", "http://h:8000",
                      "--engine-dir", "/e", "--variant", "v.json",
                      "--dry-run", "--train-cmd", "true", "--telemetry"])
    assert (a.server, a.engine_dir, a.variant, a.dry_run, a.train_cmd,
            a.telemetry) == ("http://h:8000", "/e", "v.json", True, "true",
                             True)
    a = p.parse_args(["deploy", "--autotrain", "--autotrain-dry-run"])
    assert a.autotrain and a.autotrain_dry_run
    assert not p.parse_args(["deploy"]).autotrain
    a = p.parse_args(["router", "--backends", "http://h:1", "--autopilot",
                      "--autopilot-dry-run", "--replica-cmd", "x {port}",
                      "--autotrain", "--autotrain-dry-run",
                      "--engine-dir", "/e", "--variant", "v.json",
                      "--train-cmd", "t"])
    assert (a.autopilot, a.autopilot_dry_run, a.replica_cmd, a.autotrain,
            a.autotrain_dry_run, a.engine_dir, a.variant, a.train_cmd) == (
        True, True, "x {port}", True, True, "/e", "v.json", "t")
    a = p.parse_args(["autopilot", "--router", "http://h:8100",
                      "--dry-run", "--replica-cmd", "y {port}"])
    assert (a.router, a.dry_run, a.replica_cmd) == (
        "http://h:8100", True, "y {port}")
    assert cli._DISPATCH["autotrain"] is cli.cmd_autotrain
    assert cli._DISPATCH["autopilot"] is cli.cmd_autopilot
    assert "predictionio_tpu_torch.tools.cli train" in \
        autotrain.default_train_command("/e", "engine.json")
