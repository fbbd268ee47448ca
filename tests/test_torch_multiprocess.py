"""Two real ``torch.distributed`` ranks (gloo, on the CPU) train and serve
through the port's world mesh, and ``pio train --coordinator`` runs as a
two-process job; held against the same work on two shard slots of one
process, against the replicated quantized path, and against a
single-device train.

This is the only test file that starts processes. Its rules: one
module-scoped pair of children; a ``file://`` rendezvous in a temporary
directory (no port is chosen by binding and releasing it); one thread of
intra-op work per child (``OMP_NUM_THREADS=1`` and
``torch.set_num_threads(1)``), so the pair does not starve the tests
beside it; ``communicate(timeout=...)`` and every child killed in
``finally``."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.ops import als, quant
from predictionio_tpu_torch.parallel import als_dist
from predictionio_tpu_torch.parallel.mesh import Mesh
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import model_io

from torch_deploy_util import port_cli  # noqa: F401 (fixture)

#: every test starts and ends with the port's storage singleton dropped
#: and the CLI's environment writes registered for undoing
pytestmark = pytest.mark.usefixtures("port_cli")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK, ITERS, LAM = 4, 3, 0.05
TIMEOUT_S = 150

_CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from predictionio_tpu_torch.ops import als, quant
    from predictionio_tpu_torch.parallel import als_dist, mesh, serve_dist
    from predictionio_tpu_torch.tools import cli

    rank, init, out, engine = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    spec = json.loads(sys.argv[5])
    mesh.init_distributed("local", 2, rank, init_method=init, device="cpu")
    u, i, r = (np.asarray(spec[k], dtype) for k, dtype in
               (("u", np.int32), ("i", np.int32), ("r", np.float32)))
    u0, v0 = (np.asarray(spec[k], np.float32) for k in ("u0", "v0"))
    data = als.prepare_ratings(u, i, r, spec["n_u"], spec["n_i"],
                               chunk=64)
    world = mesh.get_mesh(device="cpu")
    U, V = als_dist.train_explicit_sharded(
        world, data, rank=spec["rank"], iterations=spec["iters"],
        lambda_=spec["lam"], chunk=64, u0=u0, v0=v0)
    qf = quant.QuantizedFactors.from_factors(U.numpy(), V.numpy())
    sf = serve_dist.shard_factors(
        None, None, mesh=mesh.get_mesh(axis_name="shard", device="cpu"),
        quant=qf)
    ixs = np.asarray(spec["ixs"], np.int32)
    answers = [sf.topk(ixs, k) for k in spec["ks"]]
    rc = cli.main(["train", "--engine-dir", engine, "--synthetic", "3000",
                   "--coordinator", "local", "--num-processes", "2",
                   "--process-id", str(rank)])
    np.savez(out, U=U.numpy(), V=V.numpy(), rc=rc,
             rows=np.asarray([sf.user_base, sf.user_rows.shape[0]]),
             **{f"v{k}": a[0].numpy() for k, a in zip(spec["ks"], answers)},
             **{f"i{k}": a[1].numpy() for k, a in zip(spec["ks"], answers)})
    torch.distributed.destroy_process_group()
""")


def _problem():
    rng = np.random.default_rng(17)
    n_u, n_i, nnz = 41, 29, 700
    u = np.concatenate([rng.integers(0, n_u, nnz), np.arange(n_u),
                        rng.integers(0, n_u, n_i)]).astype(np.int32)
    i = np.concatenate([(rng.zipf(1.4, nnz) - 1) % n_i,
                        rng.integers(0, n_i, n_u),
                        np.arange(n_i)]).astype(np.int32)
    r = rng.integers(1, 11, u.shape[0]).astype(np.float32) / 2
    u0 = np.abs(rng.normal(size=(n_u, RANK))).astype(np.float32) / 2
    v0 = np.abs(rng.normal(size=(n_i, RANK))).astype(np.float32) / 2
    return {"u": u.tolist(), "i": i.tolist(), "r": r.tolist(),
            "u0": u0.tolist(), "v0": v0.tolist(), "n_u": n_u, "n_i": n_i,
            "rank": RANK, "iters": ITERS, "lam": LAM,
            "ixs": [0, 40, 20, 21, 3, 3], "ks": [1, 5, n_i]}


def _engine_dir(path, app="MPApp"):
    path.mkdir(parents=True, exist_ok=True)
    (path / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory":
            "predictionio_tpu.models.recommendation.engine:"
            "RecommendationEngine",
        "datasource": {"params": {"appName": app}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": 2, "lambda": 0.01,
            "seed": 3}}]}))
    return str(path)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results: the library train and serve over the world
    mesh, then ``pio train --coordinator`` (rank 0 writes the ledger)."""
    work = tmp_path_factory.mktemp("mp")
    spec = _problem()
    engine = _engine_dir(work / "engine")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo", PIO_TORCH_DEVICE="cpu",
               PIO_FS_BASEDIR=str(work / "store"), PIO_AUTO_RESUME="0")
    init = f"file://{work / 'rendezvous'}"
    procs = []
    try:
        for rank in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(rank), init,
                 str(work / f"rank{rank}.npz"), engine, json.dumps(spec)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
        for p, (_out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [dict(np.load(work / f"rank{r}.npz")) for r in (0, 1)]
    return {"spec": spec, "results": results, "outs": outs,
            "store": str(work / "store"), "work": work}


def _in_process_train(spec, n_slots):
    data = als.prepare_ratings(np.asarray(spec["u"], np.int32),
                               np.asarray(spec["i"], np.int32),
                               np.asarray(spec["r"], np.float32),
                               spec["n_u"], spec["n_i"], chunk=64)
    return als_dist.train_explicit_sharded(
        Mesh(["cpu"] * n_slots), data, rank=RANK, iterations=ITERS,
        lambda_=LAM, chunk=64, u0=np.asarray(spec["u0"], np.float32),
        v0=np.asarray(spec["v0"], np.float32))


def test_two_ranks_train_as_two_slots_of_one_process(two_ranks):
    spec, (r0, r1) = two_ranks["spec"], two_ranks["results"]
    # the gathered factors are the same on both ranks
    np.testing.assert_array_equal(r0["U"], r1["U"])
    np.testing.assert_array_equal(r0["V"], r1["V"])
    U, V = _in_process_train(spec, 2)
    # one Gram and one kernel-A call per slot in both; the sums run in
    # the same order, held to the train tolerance all the same
    np.testing.assert_allclose(r0["U"], U.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(r0["V"], V.numpy(), rtol=2e-3, atol=2e-4)


def test_two_ranks_serve_the_replicated_answers(two_ranks):
    spec, (r0, r1) = two_ranks["spec"], two_ranks["results"]
    # each rank holds only its own slot's user rows
    n_u = spec["n_u"]
    rows_u = -(-n_u // 2)
    assert r0["rows"].tolist() == [0, rows_u]
    assert r1["rows"].tolist() == [rows_u, rows_u]
    qf = quant.QuantizedFactors.from_factors(r0["U"], r0["V"])
    rep = quant.QuantizedServing.build(qf, device="cpu")
    for k in spec["ks"]:
        vals, idx = rep.topk(np.asarray(spec["ixs"]), k)
        for res in (r0, r1):
            assert res[f"v{k}"].tobytes() == vals.numpy().tobytes(), k
            np.testing.assert_array_equal(res[f"i{k}"], idx.numpy())


def test_pio_train_coordinator_writes_one_ledger_row(two_ranks, tmp_path,
                                                     monkeypatch):
    r0, r1 = two_ranks["results"]
    assert int(r0["rc"]) == 0 and int(r1["rc"]) == 0
    assert "Training completed. EngineInstance ID: \n" in \
        two_ranks["outs"][1][0]                      # rank 1 returns ""
    store = Storage(env={"PIO_FS_BASEDIR": two_ranks["store"]})
    rows = store.get_meta_data_engine_instances().get_all()
    assert [r.status for r in rows] == ["COMPLETED"]
    (model,) = model_io.deserialize_models(
        store.get_model_data_models().get(rows[0].id).models)
    # the same synthetic train on one device, in this process
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "one"))
    engine = _engine_dir(tmp_path / "engine")
    assert cli.main(["train", "--engine-dir", engine,
                     "--synthetic", "3000"]) == 0
    one = Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "one")})
    (row,) = one.get_meta_data_engine_instances().get_all()
    (single,) = model_io.deserialize_models(
        one.get_model_data_models().get(row.id).models)
    assert model.user_vocab.to_dict() == single.user_vocab.to_dict()
    np.testing.assert_allclose(np.asarray(model.user_factors),
                               np.asarray(single.user_factors),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(model.item_factors),
                               np.asarray(single.item_factors),
                               rtol=2e-3, atol=2e-4)


def test_rank_count_mismatch_is_refused_by_get_mesh(two_ranks):
    # a lone process (this one) has a world of one
    from predictionio_tpu_torch.parallel import mesh
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="only 1 are visible"):
        mesh.get_mesh(2, device="cpu")
