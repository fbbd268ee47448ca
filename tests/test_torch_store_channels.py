"""Event channels in the training and lookup reads (``data/store.py``'s
``_resolve_app``) against the JAX package's.

One SQLite store (the schema both packages share) holds an app whose
events are split between its default channel and a named one. An
engine.json whose data source names the channel (``channelName``)
trains, in both packages, from only that channel's events, with the same
vocabularies and counts; the lookups read the channel too, and a channel
the app lacks is the reference's "Invalid channel name" error.
"""

import dataclasses
import datetime as dt
from typing import Optional

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import Engine as JEngine
from predictionio_tpu.controller import FirstServing as JFirstServing
from predictionio_tpu.controller import Params as JParams
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Channel as JChannel
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation import data_source as jds
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSAlgorithm as JALSAlgorithm,
)
from predictionio_tpu.models.recommendation.preparator import (
    Preparator as JPreparator,
)
from predictionio_tpu.workflow import WorkflowContext as JWorkflowContext
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu.workflow import run_train as jrun_train
from predictionio_tpu_torch.controller import Engine, FirstServing, Params
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.models.recommendation import data_source as tds
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm,
)
from predictionio_tpu_torch.models.recommendation.preparator import (
    Preparator,
)
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train

APP, CHANNEL = "ChanApp", "web"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the trains here: the suite runs beside
    timing-sensitive tests in other workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _channel_engine(pkg_store, pkg_ds, params_base, engine_cls, prep,
                    algo, serving):
    """The Recommendation engine with a data source that reads one named
    channel of the app (its params: appName, channelName)."""

    @dataclasses.dataclass(frozen=True)
    class ChannelParams(params_base):
        appName: str
        channelName: Optional[str] = None

    class ChannelDataSource(pkg_ds.DataSource):
        params_class = ChannelParams

        def read_training(self, ctx):
            return pkg_ds.training_data_from_columnar(pkg_store.find_columnar(
                self.dsp.appName, channel_name=self.dsp.channelName,
                entity_type="user", event_names=["rate", "buy"],
                target_entity_type="item", storage=ctx.storage))

    return engine_cls(data_source_class=ChannelDataSource,
                      preparator_class=prep,
                      algorithm_class_map={"als": algo},
                      serving_class=serving)


VARIANT = {
    "id": "default",
    "datasource": {"params": {"appName": APP, "channelName": CHANNEL}},
    "algorithms": [{"name": "als", "params": {
        "rank": 3, "numIterations": 2, "lambda": 0.05, "seed": 5}}],
}


@pytest.fixture
def filled(tmp_path, monkeypatch):
    """The shared SQLite store: 300 seeded events on the default channel
    of the app and 200 on its ``web`` channel, over overlapping users."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    env = {"PIO_FS_BASEDIR": str(tmp_path)}
    js = JStorage(env=env)
    app_id = js.get_meta_data_apps().insert(JApp(0, APP, None))
    ch_id = js.get_meta_data_channels().insert(JChannel(0, CHANNEL, app_id))
    rng = np.random.default_rng(3)
    t0 = dt.datetime(2023, 1, 1, tzinfo=dt.timezone.utc)
    for channel, n, users in ((None, 300, 40), (ch_id, 200, 25)):
        js.get_events().init(app_id, channel)
        evs = []
        for k in range(n):
            name = "buy" if k % 9 == 0 else "rate"
            props = {} if name == "buy" else {
                "rating": float(rng.integers(1, 6))}
            evs.append(JEvent(
                event=name, entity_type="user",
                entity_id=f"u{int(rng.integers(users))}",
                target_entity_type="item",
                target_entity_id=f"i{int(rng.integers(30))}",
                properties=JDataMap(props),
                event_time=t0 + dt.timedelta(minutes=k)))
        js.get_events().insert_batch(evs, app_id, channel)
    return env, app_id, ch_id


def test_channel_name_trains_from_that_channel(filled):
    env, _app_id, _ch_id = filled
    jengine = _channel_engine(jstore, jds, JParams, JEngine, JPreparator,
                              JALSAlgorithm, JFirstServing)
    tengine = _channel_engine(store, tds, Params, Engine, Preparator,
                              ALSAlgorithm, FirstServing)
    jstorage, tstorage = JStorage(env=env), Storage(env=env)
    jparams = jengine.engine_params_from_json(VARIANT)
    tparams = tengine.engine_params_from_json(VARIANT)
    jtd = jengine._instantiate(jparams)[0].read_training(
        JWorkflowContext(storage=jstorage))
    ttd = tengine._instantiate(tparams)[0].read_training(
        WorkflowContext(storage=tstorage, device="cpu"))
    assert ttd.n == jtd.n == 200
    assert ttd.user_vocab.to_dict() == jtd.user_vocab.to_dict()
    assert ttd.item_vocab.to_dict() == jtd.item_vocab.to_dict()
    assert len(ttd.user_vocab) <= 25
    for f in ("user_idx", "item_idx", "rating"):
        np.testing.assert_array_equal(getattr(ttd, f), getattr(jtd, f))
    # the default channel alone reads the other 300
    assert store.find_columnar(APP, storage=tstorage).n == 300
    # and both packages train from the channel to completion
    jid = jrun_train(JWorkflowContext(storage=jstorage), jengine, jparams,
                     params_json=VARIANT)
    tid = run_train(WorkflowContext(storage=tstorage, device="cpu"),
                    tengine, tparams, params_json=VARIANT)
    (jm,) = jmodel_io.deserialize_models(
        jstorage.get_model_data_models().get(jid).models)
    (tm,) = model_io.deserialize_models(
        tstorage.get_model_data_models().get(tid).models)
    assert tm.user_vocab.to_dict() == jm.user_vocab.to_dict()
    assert np.asarray(tm.user_factors).shape == \
        np.asarray(jm.user_factors).shape


def test_channel_lookups_and_invalid_name(filled):
    env, _app_id, _ch_id = filled
    jstorage, tstorage = JStorage(env=env), Storage(env=env)
    user = "u3"
    want = jstore.find_target_ids(APP, "user", user, channel_name=CHANNEL,
                                  storage=jstorage)
    got = store.find_target_ids(APP, "user", user, channel_name=CHANNEL,
                                storage=tstorage)
    assert got == want and got
    want = [e.event_id for e in jstore.find_by_entity(
        APP, "user", user, channel_name=CHANNEL, storage=jstorage)]
    got = [e.event_id for e in store.find_by_entity(
        APP, "user", user, channel_name=CHANNEL, storage=tstorage)]
    assert got == want
    with pytest.raises(jstore.StoreError) as jerr:
        jstore.find_columnar(APP, channel_name="nope", storage=jstorage)
    with pytest.raises(store.StoreError) as err:
        store.find_columnar(APP, channel_name="nope", storage=tstorage)
    assert str(err.value) == str(jerr.value) == (
        f"Invalid channel name nope for app {APP}.")
