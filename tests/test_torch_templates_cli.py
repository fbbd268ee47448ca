"""The classification, similar-product and e-commerce templates through
the port's CLI on the CPU — ``pio train`` from an engine.json that names
the JAX package's factory, ``pio deploy``, one ``POST /queries.json``,
``pio undeploy`` — in a subprocess where jax and the JAX package cannot
be imported."""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TEMPLATES = textwrap.dedent("""
    import sys

    def blocked(name):
        return (name == "jax" or name.startswith(("jax.", "jaxlib"))
                or name == "predictionio_tpu"
                or name.startswith("predictionio_tpu."))

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())

    import datetime as dt, http.client, json, os, socket, threading, time
    import urllib.request
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.tools import cli

    work = sys.argv[1]
    T0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)

    def ev(name, etype, eid, props=None, target=None, k=0):
        return Event(event=name, entity_type=etype, entity_id=eid,
                     target_entity_type="item" if target else None,
                     target_entity_id=target,
                     properties=DataMap(props or {}),
                     event_time=T0 + dt.timedelta(minutes=k))

    def fill(name, events):
        storage = Storage()           # SQLite under PIO_FS_BASEDIR
        app_id = storage.get_meta_data_apps().insert(App(0, name))
        storage.get_events().init(app_id)
        store.write(events, app_id, storage=storage)

    cls_events = []
    for n in range(20):
        plan = n % 2
        lo, hi = 0.0 + (n % 3), 8.0 + (n % 3)
        cls_events.append(ev("$set", "user", f"u{n}", {
            "plan": float(plan), "attr0": hi if plan == 0 else lo,
            "attr1": 2.0, "attr2": lo if plan == 0 else hi}, k=n))
    fill("ClsApp", cls_events)
    shop = [ev("$set", "user", f"u{u}", k=u) for u in range(8)]
    shop += [ev("$set", "item", f"i{i}", {"categories": [
        "even" if i % 2 == 0 else "odd"]}, k=10 + i) for i in range(6)]
    k = 20
    for u in range(8):
        for i in range(6):
            k += 1
            match = (u % 2) == (i % 2)
            shop.append(ev("rate", "user", f"u{u}",
                           {"rating": 5.0 if match else 1.0}, f"i{i}", k))
            if match:
                shop.append(ev("view", "user", f"u{u}", None, f"i{i}", k))
    shop.append(ev("$set", "constraint", "unavailableItems",
                   {"items": ["i3"]}, k=200))
    fill("ShopApp", shop)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def wait_ready(port, deadline=60.0):
        t0 = time.time()
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/readyz", timeout=2):
                    return
            except OSError:
                if time.time() - t0 > deadline:
                    raise
                time.sleep(0.05)

    def run(engine_id, factory, datasource, algorithms, query):
        engine_dir = os.path.join(work, engine_id)
        os.makedirs(engine_dir)
        with open(os.path.join(engine_dir, "engine.json"), "w") as f:
            json.dump({"id": engine_id, "engineFactory":
                       "predictionio_tpu.models." + factory,
                       "datasource": {"params": datasource},
                       "algorithms": algorithms}, f)
        assert cli.main(["train", "--engine-dir", engine_dir]) == 0
        port, rcs = free_port(), []
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
            "--port", str(port)])))
        deploy.start()
        wait_ready(port)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/queries.json", body=json.dumps(query),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        status, body = r.status, json.loads(r.read())
        conn.close()
        assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                         str(port)]) == 0
        deploy.join(timeout=30)
        assert rcs == [0] and not deploy.is_alive()
        assert status == 200, body
        return body

    out = {}
    out["classification"] = run(
        "cls", "classification.engine:ClassificationEngine",
        {"appName": "ClsApp"},
        [{"name": "naive", "params": {"lambda": 1.0}}],
        {"features": [9.0, 2.0, 1.0]})
    out["similarproduct"] = run(
        "sim", "similarproduct.engine:SimilarProductEngine",
        {"appName": "ShopApp"},
        [{"name": "als", "params": {"rank": 4, "numIterations": 5,
                                    "lambda": 0.01, "seed": 3}}],
        {"items": ["i0"], "num": 2})
    out["ecommerce"] = run(
        "ecom", "ecommerce.engine:ECommerceEngine",
        {"appName": "ShopApp"},
        [{"name": "ecomm", "params": {"appName": "ShopApp", "rank": 4,
                                      "numIterations": 5, "lambda": 0.05,
                                      "seed": 3}}],
        {"user": "u1", "num": 3})
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print(json.dumps(out))
""")


def test_three_templates_through_the_cli_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("PIO_")}
    env.update(PYTHONPATH=REPO, PIO_FS_BASEDIR=str(tmp_path / "store"),
               PIO_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _TEMPLATES, str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["classification"] == {"label": 0.0}
    sim_items = [s["item"] for s in out["similarproduct"]["itemScores"]]
    assert len(sim_items) == 2 and set(sim_items) <= {"i2", "i4"}
    ecom_items = [s["item"] for s in out["ecommerce"]["itemScores"]]
    # u1 rates the odd items 5; i3 is unavailable
    assert len(ecom_items) == 3 and "i3" not in ecom_items
    assert set(ecom_items[:2]) == {"i1", "i5"}
    assert "degraded" not in out["ecommerce"]
