"""The port's ``common/resilience.py`` against the reference's: the retry
policy's backoff sequence, the circuit breaker's states under an
injected clock, the fault injector's decisions for one spec, seed and
call sequence in every fault kind and scope, the spec errors, and the
journal events and counters of a breaker's transitions. Every
comparison is exact: nothing here does arithmetic on the card, and both
packages draw from ``random.Random`` with the same seed."""

import random

import numpy as np
import pytest

from predictionio_tpu.common import journal as ref_journal
from predictionio_tpu.common import resilience as ref
from predictionio_tpu.common import telemetry as ref_telemetry
from predictionio_tpu_torch.common import journal as port_journal
from predictionio_tpu_torch.common import resilience as port
from predictionio_tpu_torch.common import telemetry as port_telemetry

PACKAGES = ((ref, ref_journal, ref_telemetry),
            (port, port_journal, port_telemetry))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No installed injector, shared breaker or journal record leaks in
    or out; the journals' clocks read one fixed instant."""
    for mod, jr, tm in PACKAGES:
        mod.clear()
        mod.CircuitBreaker.reset_registry()
        jr.set_enabled(True)
        jr.clear()
        tm.set_enabled(None)
        monkeypatch.setattr(jr, "_wall_now", lambda: 1_700_000_000.25)
    for name in ("PIO_FAULT_SPEC", "PIO_FAULT_SEED", "PIO_RPC_RETRIES",
                 "PIO_RPC_BACKOFF_MS", "PIO_RPC_BACKOFF_MAX_MS",
                 "PIO_RPC_DEADLINE_MS", "PIO_BREAKER_ENABLED"):
        monkeypatch.delenv(name, raising=False)
    yield
    for mod, jr, tm in PACKAGES:
        mod.clear()
        mod.CircuitBreaker.reset_registry()
        jr.set_enabled(None)
        jr.clear()
        tm.set_enabled(None)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,props", [
    ({}, {}),
    ({"PIO_RPC_RETRIES": "4", "PIO_RPC_BACKOFF_MS": "25"}, {}),
    ({"PIO_RPC_RETRIES": "2", "PIO_RPC_BACKOFF_MS": "100",
      "PIO_RPC_BACKOFF_MAX_MS": "150", "PIO_RPC_DEADLINE_MS": "900"},
     {"RETRIES": "6"}),
    ({"PIO_RPC_BACKOFF_MS": "junk"}, {"BACKOFF_MS": "junk",
                                      "DEADLINE_MS": "40"}),
])
def test_retry_policy_backoff_sequence_is_the_reference(monkeypatch, env,
                                                        props):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a = ref.RetryPolicy.from_env("PIO_RPC", properties=props)
    b = port.RetryPolicy.from_env("PIO_RPC", properties=props)
    assert (a.max_attempts, a.base_delay_s, a.max_delay_s,
            a.total_deadline_s, a.configured) == (
        b.max_attempts, b.base_delay_s, b.max_delay_s, b.total_deadline_s,
        b.configured)
    floors = np.random.default_rng(5).uniform(0, 0.2, size=12)
    seq = []
    for pol in (a, b):
        rng = random.Random(1234)
        seq.append([pol.backoff_s(k, floor=float(f), rng=rng)
                    for k, f in enumerate(floors)]
                   + [pol.may_retry(k, deadline=10.0, clock=lambda: t)
                      for k in range(8) for t in (5.0, 10.0)])
    assert seq[0] == seq[1]


def test_retry_policy_call_gives_up_and_journals_alike():
    """RetryPolicy.call runs the same attempts, sleeps the same pauses and
    journals the same give-up record in both packages."""
    out = []
    for mod, jr, _tm in PACKAGES:
        pol = mod.RetryPolicy(max_attempts=3, base_delay_s=0.01)
        tries, sleeps = [], []

        def flaky():
            tries.append(1)
            raise ConnectionError("down")
        flaky.__name__ = "flaky"
        random.seed(7)
        with pytest.raises(ConnectionError):
            pol.call(flaky, sleep=sleeps.append)
        out.append((len(tries), sleeps, jr.snapshot()["events"]))
    assert out[0] == out[1]
    assert out[1][0] == 3 and out[1][2][0]["category"] == "retry"


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def _drive_breaker(mod, steps, **kw):
    """Feed one call/outcome sequence under a hand-moved clock; record
    the state, stats and fast-fail decision after every step."""
    now = [0.0]
    br = mod.CircuitBreaker("ep:1", clock=lambda: now[0], **kw)
    trail = []
    for dt, ok in steps:
        now[0] += dt
        before = br.state
        try:
            br.allow()
            admitted = True
        except mod.CircuitOpenError as e:
            admitted = f"open {e.retry_in_s:.6f} {e}"
        if admitted is True:
            br.record(ok)
        trail.append((before, admitted, br.state, br.stats()))
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_state_sequence_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    # bursts of failures with quiet gaps: the breaker opens, half-opens,
    # fails a probe or closes, more than once
    steps = [(float(rng.choice([0.05, 0.4, 1.7])),
              bool(rng.random() < (0.2 if (k // 15) % 2 else 0.9)))
             for k in range(120)]
    kw = dict(window_s=3.0, error_threshold=0.5, min_calls=4, open_s=1.0,
              half_open_max=1)
    a = _drive_breaker(ref, steps, **kw)
    b = _drive_breaker(port, steps, **kw)
    assert a == b
    assert {s for s, _a, _s, _st in b} >= {"closed", "open", "half-open"}


def test_breaker_journal_and_counters_of_open_half_open_close():
    """The journal records of one open -> half-open -> re-open ->
    half-open -> close walk, and the transitions counter, are the
    reference's byte for byte."""
    texts, events = [], []
    for mod, jr, tm in PACKAGES:
        tm.set_enabled(True)
        reg = tm.registry()
        reg.reset()                   # the counters start at zero
        now = [0.0]
        br = mod.CircuitBreaker("storage:7072", clock=lambda: now[0],
                                min_calls=2, open_s=1.0)
        for _ in range(2):
            br.allow()
            br.record(False)          # opens
        now[0] = 1.5
        br.allow()                    # half-open probe
        br.record(False)              # re-opens
        now[0] = 3.0
        br.allow()
        br.record(True)               # closes
        events.append(jr.snapshot()["events"])
        texts.append("\n".join(
            line for line in reg.exposition().splitlines()
            if "pio_breaker_transitions_total" in line
            and not line.startswith("#")))
    assert events[0] == events[1]
    assert [e["fields"]["to"] for e in events[1]] == [
        "open", "half-open", "open", "half-open", "closed"]
    assert [e["level"] for e in events[1]] == [
        "red", "warn", "red", "warn", "info"]
    assert texts[0] == texts[1] and texts[1]


def test_shared_breaker_registry_reads_the_environment(monkeypatch):
    for k, v in {"PIO_BREAKER_ENABLED": "1", "PIO_BREAKER_WINDOW_S": "7",
                 "PIO_BREAKER_ERROR_RATE": "0.25",
                 "PIO_BREAKER_MIN_CALLS": "3",
                 "PIO_BREAKER_OPEN_S": "0.5"}.items():
        monkeypatch.setenv(k, v)
    got = []
    for mod, _jr, _tm in PACKAGES:
        br = mod.CircuitBreaker.for_endpoint("h:1")
        assert mod.CircuitBreaker.for_endpoint("h:1") is br
        got.append((br.window_s, br.error_threshold, br.min_calls,
                    br.open_s))
    assert got[0] == got[1] == (7.0, 0.25, 3, 0.5)
    monkeypatch.setenv("PIO_BREAKER_ENABLED", "0")
    assert port.CircuitBreaker.for_endpoint("h:2") is None


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

#: every fault kind, with and without max-fires and a scope
SPECS = [
    "drop:0.3",
    "drop:0.5:2",
    "drop_rx:0.4",
    "drop_rx:1:1@client POST /rpc",
    "latency:0.5:0",
    "error:0.3:502",
    "error:0.6",
    "truncate:0.5",
    "truncate:1@read_columns",
    "drop:0.2@server,error:0.2:503@client,truncate:0.3",
    "drop_rx:0.3@/rpc/model,latency:1:0@GET,drop:0.1:3",
]
CALLS = [("client", "POST /rpc"), ("server", "POST /rpc"),
         ("client", "POST /rpc/read_columns"), ("client", "GET /rpc/model"),
         ("server", "GET /readyz"), ("client", "POST /rpc/model")]


def _decisions(mod, spec: str, seed: int, order) -> list:
    inj = mod.FaultInjector(spec, seed=seed)
    out = []
    for i in order:
        boundary, route = CALLS[i]
        step = []
        for hook in ("before_send", "after_send"):
            try:
                getattr(inj, hook)(boundary, route)
                step.append("pass")
            except mod.InjectedFault as e:
                step.append(f"{type(e).__name__}: {e}")
        step.append(inj.on_response(boundary, route, 200,
                                    b'{"result": [1, 2, 3, 4]}'))
        out.append(step)
    return out + [dict(inj.fired), dict(inj._counts)]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 42])
def test_fault_injector_decisions_are_the_reference(spec, seed):
    order = np.random.default_rng(seed).integers(0, len(CALLS), size=60)
    assert _decisions(ref, spec, seed, order) == \
        _decisions(port, spec, seed, order)


@pytest.mark.parametrize("spec", [
    "drop", "nonsense:0.5", "drop:x", "drop:1.5", "error:0.5:abc",
    "drop:-0.1", ":0.5", "latency:two:1@server"])
def test_fault_spec_errors_are_the_reference(spec):
    msgs = []
    for mod, _jr, _tm in PACKAGES:
        with pytest.raises(mod.FaultSpecError) as e:
            mod.FaultInjector(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_install_clear_and_the_environment(monkeypatch):
    """``install`` wins over PIO_FAULT_SPEC; ``clear`` falls back to it,
    seeded by PIO_FAULT_SEED, one injector per spec value; unset means
    no injector. The same decisions as the reference either way."""
    for mod, _jr, _tm in PACKAGES:
        assert mod.active() is None
    monkeypatch.setenv("PIO_FAULT_SPEC", "drop:0.5@client GET /")
    monkeypatch.setenv("PIO_FAULT_SEED", "9")
    got = []
    for mod, _jr, _tm in PACKAGES:
        env_inj = mod.active()
        assert env_inj is not None and mod.active() is env_inj
        inst = mod.install("error:1:504")
        assert mod.active() is inst
        mod.clear()
        assert mod.active() is env_inj
        seq = []
        for _ in range(20):
            try:
                env_inj.before_send("client", "GET /")
                seq.append(0)
            except ConnectionError:
                seq.append(1)
        got.append(seq)
    assert got[0] == got[1] and 0 < sum(got[1]) < 20
    monkeypatch.delenv("PIO_FAULT_SPEC")
    assert port.active() is None


def test_degraded_scope_journals_as_the_reference():
    out = []
    for mod, jr, _tm in PACKAGES:
        mod.reset_degraded()
        mod.note_degraded("seen-items lookup failed")
        out.append((mod.pop_degraded(), jr.snapshot()["events"]))
    assert out[0] == out[1]
