"""The port's control loop, resilience layer and durable state, held
against the JAX package's.

Both packages drive the same ``FakeClock`` episodes (the same depth
script, fault schedule, resilience knobs and crash plan) through their own
``ControlLoop``, ``QueueMetricSource`` over ``FakeQueueService``,
``PodAutoScaler`` over ``FakeDeploymentAPI``, ``TickJournal``,
``ControllerMetrics`` and ``DurableStateStore``; the results are compared
field by field: tick record dicts, journal bytes, snapshot bytes, the
scaler's writes, breaker transitions, retry counts and the rendered
metrics (less the wall-clock lines).  Then the primitives one by one, and
the files each package reads of the other's: a reference snapshot
rehydrates the port's loop, a port journal reads through the reference's
reader.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from dataclasses import dataclass

import pytest

ROOTS = ("kube_sqs_autoscaler_tpu", "kube_sqs_autoscaler_tpu_torch")


class Side:
    """One package's controller modules under one set of names."""

    def __init__(self, root: str) -> None:
        self.root = root

        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.version = importlib.import_module(root).__version__
        self.clock = m("core.clock")
        self.loop = m("core.loop")
        self.policy = m("core.policy")
        self.res = m("core.resilience")
        self.durable = m("core.durable")
        self.events = m("core.events")
        self.mfake = m("metrics.fake")
        self.queue = m("metrics.queue")
        self.actuator = m("scale.actuator")
        self.sfake = m("scale.fake")
        self.faults = m("sim.faults")
        self.journal = m("obs.journal")
        self.prom = m("obs.prometheus")
        self.trace = m("obs.trace")
        self.server = m("obs.server")


REF, PORT = Side(ROOTS[0]), Side(ROOTS[1])
SIDES = (REF, PORT)

# the depth the queue reports during poll interval k (k >= 1), repeating
# the last: a backlog that fires the up gate across its cooldown, a lull,
# an empty queue that fires the down gate, and a second burst
DEPTHS = [150] * 6 + [50] * 3 + [5] * 10 + [300] * 6 + [0] * 5


@dataclass
class Scenario:
    resilience: dict | None = None
    faults: str = "none"
    durable: bool = False
    ticks: int = 30
    crash: tuple | None = None  # (tick index, crash point)
    downtime: float = 7.0


RESILIENCE = {
    "off": None,
    "defaults": {},
    "retries": dict(metric_retries=2, scaler_retries=2, retry_seed=3),
    "timeouts": dict(metric_timeout=0.5, scaler_timeout=0.5),
    "breaker": dict(breaker_failures=2, breaker_reset=12.0),
    "stale": dict(stale_depth_ttl=12.0),
    "full": dict(metric_retries=2, scaler_retries=1, metric_timeout=0.5,
                 scaler_timeout=0.5, breaker_failures=2, breaker_reset=12.0,
                 stale_depth_ttl=12.0, retry_seed=7),
}


def make_faults(side: Side, name: str):
    f = side.faults
    return {
        "none": lambda: None,
        "metric-blackout": lambda: f.Blackout(start=20.0, duration=25.0),
        "scaler-blackout": lambda: f.Blackout(
            start=20.0, duration=30.0, metric=False, scale=True,
            latency=0.3),
        "correlated": lambda: f.compose(
            f.Blackout(start=60.0, duration=50.0),
            f.Blackout(start=70.0, duration=40.0, metric=False, scale=True)),
        "bursty": lambda: f.BurstyOutage(period=40.0, outage_len=12.0,
                                         metric=True, scale=True),
        "flaky": lambda: f.FlakyCalls(0.3, seed=3, metric=True, scale=True),
        "spikes": lambda: f.LatencySpikes(period=30.0, spike_len=10.0,
                                          delay=0.7, metric=True,
                                          scale=True),
    }[name]()


class ClockedQueue:
    """A ``FakeQueueService`` whose visible depth follows :data:`DEPTHS`
    on the episode's clock (poll interval 5 s)."""

    def __init__(self, side: Side, clock) -> None:
        self.inner = side.mfake.FakeQueueService.with_depths(0)
        self.clock = clock

    def get_queue_attributes(self, queue_url, attribute_names):
        k = max(0, int(self.clock.now() // 5.0 + 1e-9) - 1)
        self.inner.set_depths(DEPTHS[min(k, len(DEPTHS) - 1)])
        return self.inner.get_queue_attributes(queue_url, attribute_names)


class Collector:
    def __init__(self):
        self.records = []

    def on_tick(self, record):
        self.records.append(record.to_dict())


_WALL = re.compile(
    r"^kube_sqs_autoscaler_(last_successful_\w+_timestamp|"
    r"process_uptime_seconds|rehydration_duration_seconds) .*$\n?",
    re.MULTILINE)


def scrub(text: str) -> str:
    """The rendered metrics less their wall-clock values and the build's
    version label."""
    return re.sub(r'version="[^"]*"', 'version=""', _WALL.sub("", text))


def run_episode(side: Side, tmp_path, sc: Scenario) -> dict:
    clock = side.clock.FakeClock()
    api = side.sfake.FakeDeploymentAPI.with_deployments(
        "default", 2, "workers")
    world = side.sfake.RecordingDeploymentAPI(api, clock)
    service = ClockedQueue(side, clock)
    base = tmp_path / side.root
    base.mkdir(exist_ok=True)
    journal_path, state_path = base / "journal.jsonl", base / "state.json"
    faults = make_faults(side, sc.faults)
    plan = (side.faults.CrashPlan(crashes=(sc.crash,))
            if sc.crash is not None else None)
    tick = {"i": -1}
    collector = Collector()
    metrics = side.prom.ControllerMetrics(version=side.version)
    reports = []

    def boot():
        store = None
        if sc.durable:
            store = side.durable.DurableStateStore(
                str(state_path), wall_clock=clock.now,
                journal_path=str(journal_path))
            store.metrics = metrics
        metric = side.queue.QueueMetricSource(
            service, "q://jobs", ("ApproximateNumberOfMessages",))
        scaler = side.actuator.PodAutoScaler(
            client=world, max=5, min=1, scale_up_pods=1, scale_down_pods=1,
            deployment="workers", namespace="default")
        if faults is not None:
            metric = side.faults.FaultyMetricSource(metric, faults, clock)
            scaler = side.faults.FaultyScaler(scaler, faults, clock)
        if plan is not None:
            metric = side.faults.CrashingMetricSource(
                metric, plan, lambda: tick["i"])
            scaler = side.faults.CrashingScaler(
                scaler, plan, lambda: tick["i"])
        resilience = (None if sc.resilience is None
                      else side.res.ResilienceConfig(**sc.resilience))
        loop = side.loop.ControlLoop(
            scaler, metric,
            side.loop.LoopConfig(poll_interval=5.0,
                                 policy=side.policy.PolicyConfig(
                                     scale_up_messages=100,
                                     scale_down_messages=10,
                                     scale_up_cooldown=10.0,
                                     scale_down_cooldown=20.0)),
            clock=clock, resilience=resilience, durable=store)
        meta = {"source": "test", "poll_interval": 5.0}
        if store is not None:
            if loop.resilience is not None:
                store.register("resilience", loop.resilience, ttl_s=3600.0)
            meta = store.journal_meta_after_rehydrate(clock.now(), meta)
            reports.append({k: v for k, v in store.last_report.to_dict()
                            .items() if k != "duration_s"})
        journal = side.journal.TickJournal(str(journal_path), meta=meta)
        sink = (side.faults.CrashingJournal(journal, plan, lambda: tick["i"])
                if plan is not None else journal)
        loop.observer = side.events.MultiObserver([collector, metrics, sink])
        return loop, journal, store

    loop, journal, store = boot()
    state = loop.initial_policy_state()
    crashes = 0
    for i in range(sc.ticks):
        tick["i"] = i
        clock.advance(5.0)  # sleep first, as run() does
        try:
            state = loop.tick(state)
        except side.durable.ControllerCrash:
            crashed = True
        else:
            crashed = plan is not None and plan.boundary_crash(i)
        if crashed:
            crashes += 1
            journal.close()
            clock.advance(sc.downtime)
            loop, journal, store = boot()
            state = loop.initial_policy_state()
    journal.close()
    states = [r.get("breaker_state") for r in collector.records]
    return {
        "records": collector.records,
        "journal": journal_path.read_bytes(),
        "snapshot": state_path.read_bytes() if sc.durable else None,
        "writes": world.scale_times,
        "attempts": world.update_attempts,
        "state": (state.last_scale_up, state.last_scale_down),
        "transitions": [s for j, s in enumerate(states)
                        if s is not None and (j == 0 or states[j - 1] != s)],
        "retries": (sum(r.get("metric_retries", 0) for r in collector.records),
                    sum(r.get("scaler_retries", 0) for r in collector.records)),
        "metrics": scrub(metrics.render()),
        "reports": reports,
        "crashes": crashes,
    }


def fresh(tmp_path, name: str):
    """A new directory ``name`` under ``tmp_path``."""
    path = tmp_path / name
    path.mkdir()
    return path


def assert_same(ref: dict, port: dict) -> None:
    for key in ref:
        assert port[key] == ref[key], key


# ---------------------------------------------------------------------------
# Whole episodes: every resilience setting under every fault schedule, with
# and without the durable store
# ---------------------------------------------------------------------------

FAULTS = ("none", "metric-blackout", "scaler-blackout", "correlated",
          "bursty", "flaky", "spikes")


@pytest.mark.parametrize("durable", [False, True], ids=["mem", "durable"])
@pytest.mark.parametrize("faults", FAULTS)
@pytest.mark.parametrize("resilience", list(RESILIENCE))
def test_episode_matches_reference(tmp_path, resilience, faults, durable):
    sc = Scenario(resilience=RESILIENCE[resilience], faults=faults,
                  durable=durable)
    ref = run_episode(REF, tmp_path, sc)
    port = run_episode(PORT, tmp_path, sc)
    assert_same(ref, port)
    assert len(port["records"]) == sc.ticks
    if durable:
        # the store changes nothing about the ticks themselves
        plain = run_episode(PORT, fresh(tmp_path, "plain"),
                            dataclasses.replace(sc, durable=False))
        assert plain["records"] == port["records"]


def test_episodes_exercise_the_layer(tmp_path):
    """The fault schedules above really reach every mechanism."""
    breaker = run_episode(PORT, fresh(tmp_path, "breaker"), Scenario(
        resilience=RESILIENCE["full"], faults="scaler-blackout"))
    stale = run_episode(PORT, fresh(tmp_path, "stale"), Scenario(
        resilience=RESILIENCE["full"], faults="metric-blackout"))
    off = run_episode(PORT, fresh(tmp_path, "off"),
                      Scenario(faults="correlated"))
    assert breaker["transitions"] == ["closed", "open", "closed"]
    assert any("circuit breaker open" in (r.get("up_error") or "")
               for r in breaker["records"])
    assert breaker["retries"][1] > 0 and stale["retries"][0] > 0
    assert any(r.get("stale") for r in stale["records"])
    assert not any("breaker_state" in r for r in off["records"])
    assert any("metric_error" in r for r in off["records"])


# ---------------------------------------------------------------------------
# Crash points: the controller killed inside a tick and restarted from its
# snapshot, journal tail and write-ahead intent
# ---------------------------------------------------------------------------

CRASH_POINTS = ("after-observe", "after-decide",
                "after-actuate-before-journal", "torn-mid-journal-line",
                "tick-boundary")


def firing_tick(sc: Scenario, tmp_path) -> int:
    """The index of the second tick whose up gate fires, crash-free."""
    run = run_episode(REF, fresh(tmp_path, "probe"),
                      dataclasses.replace(sc, crash=None))
    fires = [i for i, r in enumerate(run["records"]) if r.get("up") == "fire"]
    return fires[1]


@pytest.mark.parametrize("resilience", ["off", "full"])
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_point_matches_reference(tmp_path, point, resilience):
    sc = Scenario(resilience=RESILIENCE[resilience], durable=True,
                  faults="none" if resilience == "off" else "flaky")
    sc.crash = (firing_tick(sc, tmp_path), point)
    ref = run_episode(REF, tmp_path, sc)
    port = run_episode(PORT, tmp_path, sc)
    assert_same(ref, port)
    assert port["crashes"] == 1 and len(port["reports"]) == 2
    assert not port["reports"][1]["cold_start"]
    replicas = [2] + [r for _, r in port["writes"]]
    ups = [t for (t, r), before in zip(port["writes"], replicas) if r > before]
    # never a double scale: consecutive scale-ups at least a cooldown apart
    assert all(b - a >= 10.0 - 1e-9 for a, b in zip(ups, ups[1:]))


def test_run_matches_reference():
    out = []
    for side in SIDES:
        clock = side.clock.FakeClock()
        collector = Collector()
        loop = side.loop.ControlLoop(
            side.actuator.PodAutoScaler(
                client=side.sfake.FakeDeploymentAPI.with_deployments(
                    "d", 1, "w"),
                max=3, min=1, scale_up_pods=1, scale_down_pods=1,
                deployment="w", namespace="d"),
            side.queue.QueueMetricSource(ClockedQueue(side, clock), "q",
                                         ("ApproximateNumberOfMessages",)),
            side.loop.LoopConfig(poll_interval=5.0),
            clock=clock, observer=collector,
            resilience=side.res.ResilienceConfig(breaker_failures=1))
        loop.run(max_ticks=25)
        out.append(collector.records)
    assert out[0] == out[1] and len(out[1]) == 25


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_retry_jitter_is_the_references(seed):
    delays = []
    for side in SIDES:
        policy = side.res.RetryPolicy(5, base_delay=0.2, max_delay=2.0,
                                      jitter=0.5, seed=seed)
        delays.append([policy.delay(a) for a in range(8)])
    assert delays[0] == delays[1]


@pytest.mark.parametrize("fail_first,retries,deadline", [
    (0, 2, None), (2, 2, None), (3, 2, None), (3, 5, 0.5), (1, 1, 0.1),
])
def test_retry_run_matches_reference(fail_first, retries, deadline):
    outcomes = []
    for side in SIDES:
        clock = side.clock.FakeClock()
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            if calls["n"] <= fail_first:
                raise ConnectionError(f"attempt {calls['n']}")
            return calls["n"]

        seen = []
        try:
            got = side.res.RetryPolicy(retries, seed=1).run(
                fn, clock, deadline=deadline, on_attempts=seen.append)
        except ConnectionError as err:
            got = ("raised", str(err))
        outcomes.append((got, seen, clock.now(), clock.sleeps))
    assert outcomes[0] == outcomes[1]


OPS = {
    "trip-and-heal": [("f", 0), ("f", 1), ("a", 2), ("a", 12), ("s", 12)],
    "probe-fails": [("f", 0), ("f", 1), ("a", 11), ("f", 11), ("a", 15),
                    ("a", 21.5), ("s", 22)],
    "success-resets": [("f", 0), ("s", 1), ("f", 2), ("a", 3), ("f", 4),
                       ("a", 5)],
    "boundary": [("f", 0), ("f", 0), ("a", 9.999), ("a", 10.0), ("s", 10)],
    "closed": [("a", 0), ("s", 1), ("a", 2)],
}


@pytest.mark.parametrize("ops", list(OPS))
def test_circuit_breaker_matches_reference(ops):
    traces = []
    for side in SIDES:
        breaker = side.res.CircuitBreaker(2, 10.0)
        trace = []
        for op, t in OPS[ops]:
            if op == "a":
                trace.append(("allow", breaker.allow(t),
                              breaker.seconds_until_probe(t)))
            elif op == "f":
                breaker.record_failure(t)
            else:
                breaker.record_success()
            trace.append((breaker.state, breaker.failures, breaker.opened_at))
        traces.append(trace)
    assert traces[0] == traces[1]


@pytest.mark.parametrize("took,timeout", [(0.0, 0.0), (0.5, 1.0), (1.0, 1.0),
                                          (1.5, 1.0)])
def test_call_with_deadline_matches_reference(took, timeout):
    out = []
    for side in SIDES:
        clock = side.clock.FakeClock()

        def fn():
            clock.advance(took)
            return "ok"

        try:
            out.append(side.res.call_with_deadline(fn, clock, timeout))
        except side.res.DeadlineExceeded as err:
            out.append(("deadline", str(err)))
    assert out[0] == out[1]


def test_resilience_config_and_codes_are_the_references():
    assert [(f.name, f.default) for f in dataclasses.fields(
        PORT.res.ResilienceConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(
            REF.res.ResilienceConfig)]
    assert PORT.res.BREAKER_STATE_CODES == REF.res.BREAKER_STATE_CODES
    assert not PORT.res.ResilienceConfig().enabled
    assert issubclass(PORT.res.CircuitOpenError,
                      importlib.import_module(
                          "kube_sqs_autoscaler_tpu_torch.core.types")
                      .ScaleError)
    with pytest.raises(ValueError):
        PORT.res.RetryPolicy(-1)
    with pytest.raises(ValueError):
        PORT.res.CircuitBreaker(0, 1.0)


@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_resilience_state_crosses_packages(src, dst):
    def policy(side):
        return side.res.ResiliencePolicy(
            side.res.ResilienceConfig(breaker_failures=1, breaker_reset=30.0,
                                      stale_depth_ttl=60.0),
            side.clock.FakeClock(100.0), 5.0)

    first = policy(src)
    record = src.events.TickRecord(start=100.0)
    assert first.observe(lambda: 42, record) == 42
    with pytest.raises(Exception):
        first.actuate(lambda: (_ for _ in ()).throw(RuntimeError("x")),
                      record)
    exported = json.loads(json.dumps(first.export_state()))
    restored = policy(dst)
    assert restored.import_state(exported, rebase=-50.0) == 2
    twin = policy(src)
    assert twin.import_state(exported, rebase=-50.0) == 2
    assert restored.export_state() == twin.export_state()
    assert restored.stale_depth(60.0) == twin.stale_depth(60.0) == (42, 10.0)


# ---------------------------------------------------------------------------
# The durable store: refusals, intents and the files each package reads of
# the other's
# ---------------------------------------------------------------------------


def write_snapshot(side: Side, path, clock, up=90.0, down=40.0, intent=None):
    store = side.durable.DurableStateStore(str(path), wall_clock=clock.now)
    store.snapshot(clock_now=clock.now(), policy_state=side.policy.PolicyState(
        last_scale_up=up, last_scale_down=down), ticks=9)
    if intent is not None:
        clock.advance(1.0)
        store.note_intent(intent, clock.now())
    return store


def rehydrate(side: Side, path, clock):
    store = side.durable.DurableStateStore(str(path), wall_clock=clock.now)
    report = store.rehydrate(clock.now())
    state = store.restored_policy_state()
    report = {k: v for k, v in report.to_dict().items() if k != "duration_s"}
    return report, (None if state is None else
                    (state.last_scale_up, state.last_scale_down))


@pytest.mark.parametrize("intent", [None, "up", "down"])
@pytest.mark.parametrize("writer", [REF, PORT], ids=["ref-writes",
                                                     "port-writes"])
def test_snapshot_rehydrates_the_other_package(tmp_path, writer, intent):
    clock = writer.clock.FakeClock(100.0)
    write_snapshot(writer, tmp_path / "s.json", clock, intent=intent)
    clock.advance(25.0)
    got = [rehydrate(side, tmp_path / "s.json", clock) for side in SIDES]
    assert got[0] == got[1]
    report, state = got[1]
    assert not report["cold_start"] and report["intent_applied"] == intent
    assert state == ((101.0 if intent == "up" else 90.0),
                     (101.0 if intent == "down" else 40.0))


def test_port_loop_starts_from_a_reference_snapshot(tmp_path):
    clock = REF.clock.FakeClock(100.0)
    write_snapshot(REF, tmp_path / "s.json", clock, up=95.0, down=80.0)
    clock.advance(10.0)
    port_clock = PORT.clock.FakeClock(clock.now())
    store = PORT.durable.DurableStateStore(str(tmp_path / "s.json"),
                                           wall_clock=port_clock.now)
    loop = PORT.loop.ControlLoop(object(), object(), clock=port_clock,
                                 durable=store)
    state = loop.initial_policy_state()
    assert state == PORT.policy.PolicyState(last_scale_up=95.0,
                                            last_scale_down=80.0)
    assert store.last_report.restarts == 1


CORRUPTIONS = {
    "truncated": lambda text: text[: len(text) // 2],
    "not-json": lambda text: "{nope",
    "wrong-kind": lambda text: json.dumps({**json.loads(text),
                                           "kind": "other"}),
    "future-schema": lambda text: json.dumps({**json.loads(text),
                                              "schema": 99}),
    "hash-mismatch": lambda text: json.dumps({**json.loads(text),
                                              "ticks": 10 ** 6}),
}


@pytest.mark.parametrize("corruption", list(CORRUPTIONS))
def test_refusals_match_reference(tmp_path, corruption):
    clock = REF.clock.FakeClock(100.0)
    write_snapshot(REF, tmp_path / "s.json", clock)
    path = tmp_path / "s.json"
    path.write_text(CORRUPTIONS[corruption](path.read_text()))
    got = [rehydrate(side, path, clock) for side in SIDES]
    assert got[0] == got[1]
    assert got[1][0]["cold_start"] and got[1][1] is None


def test_content_hash_and_schema_are_the_references():
    body = {"kind": "control-plane-snapshot", "schema": 1,
            "sections": {"a": {"records": 2, "x": [1.5, "y"]}}, "hash": "z"}
    assert PORT.durable._content_hash(body) == REF.durable._content_hash(body)
    assert (PORT.durable.SNAPSHOT_SCHEMA_VERSION
            == REF.durable.SNAPSHOT_SCHEMA_VERSION)
    assert issubclass(PORT.durable.ControllerCrash, BaseException)
    assert not issubclass(PORT.durable.ControllerCrash, Exception)


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port-journal-ref-reader",
                              "ref-journal-port-reader"])
def test_journal_reads_through_the_other_package(tmp_path, writer, reader):
    sc = Scenario(resilience=RESILIENCE["full"], faults="correlated",
                  durable=True, crash=(12, "torn-mid-journal-line"))
    run = run_episode(writer, tmp_path, sc)
    path = tmp_path / writer.root / "journal.jsonl"
    theirs = reader.journal.read_journal_episodes(str(path))
    ours = writer.journal.read_journal_episodes(str(path))
    assert [(m, [r.to_dict() for r in rs]) for m, rs in theirs] == [
        (m, [r.to_dict() for r in rs]) for m, rs in ours]
    assert len(theirs) == 2 and "restart" in theirs[1][0]
    assert sum(len(rs) for _, rs in theirs) == len(run["records"]) - 1


# ---------------------------------------------------------------------------
# FleetDriver: the controller (loop and in-process pool) killed at each
# crash point and restarted by its factory
# ---------------------------------------------------------------------------


def fleet_episode(side: Side, stub, tmp_path, point: str) -> dict:
    fleet = importlib.import_module(f"{side.root}.fleet")
    clock = side.clock.FakeClock()
    base = fresh(tmp_path, side.root)
    plan = side.faults.CrashPlan(crashes=((3, point),))
    service = ClockedQueue(side, clock)
    collector = Collector()
    holder = {}

    def tick_index():
        return holder["driver"].tick_index - 1

    def boot(initial):
        pool = fleet.WorkerPool(lambda p: stub(), min=1, max=4,
                                initial=initial, clock=clock)
        store = side.durable.DurableStateStore(
            str(base / "s.json"), wall_clock=clock.now,
            journal_path=str(base / "j.jsonl"))
        store.register("fleet", pool)
        loop = side.loop.ControlLoop(
            side.faults.CrashingScaler(pool, plan, tick_index),
            side.faults.CrashingMetricSource(side.queue.QueueMetricSource(
                service, "q", ("ApproximateNumberOfMessages",)), plan,
                tick_index),
            side.loop.LoopConfig(poll_interval=5.0, policy=(
                side.policy.PolicyConfig(scale_up_cooldown=10.0,
                                         scale_down_cooldown=20.0))),
            clock=clock, durable=store)
        meta = store.journal_meta_after_rehydrate(clock.now(), {"m": 1})
        journal = side.journal.TickJournal(str(base / "j.jsonl"), meta=meta)
        holder["journals"].append(journal)
        loop.observer = side.events.MultiObserver([
            collector, side.faults.CrashingJournal(journal, plan,
                                                   tick_index)])
        return pool, loop

    holder["journals"] = []
    pool, loop = boot(1)
    driver = fleet.FleetDriver(
        pool, loop, cycle_dt=1.0, crash_plan=plan,
        restart=lambda: boot(holder["driver"].pool.replicas),
        downtime_s=3.0)
    holder["driver"] = driver
    summary = driver.run(max_cycles=120)
    for journal in holder["journals"]:
        journal.close()
    return {"summary": summary, "records": collector.records,
            "journal": (base / "j.jsonl").read_bytes(),
            "events": [(e.name, e.t) for e in driver.pool.events]}


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_fleet_driver_crash_and_restart_match_reference(tmp_path, point):
    from .test_actuator_contract import _StubWorker as RefStub
    from .test_torch_fleet import _StubWorker as PortStub

    ref = fleet_episode(REF, RefStub, fresh(tmp_path, "ref"), point)
    port = fleet_episode(PORT, PortStub, fresh(tmp_path, "port"), point)
    assert port == ref
    assert port["summary"]["crashes"] == port["summary"]["restarts"] == 1
    assert max(port["summary"]["replica_trajectory"]) >= 2
