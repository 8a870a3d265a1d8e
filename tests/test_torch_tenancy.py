"""The port's tenancy host classes held against the JAX package's.

``TenancyConfig``'s rejections, ``DeficitRoundRobin`` (with the EDF jump,
``refund``, ``pop_over_deadline``, ``pop_tail`` and pruning),
``FairAdmission`` (staging caps, the flood classifier, ``adopt_flood``),
``OverloadLadder``, the tenant-home state and the pool key: both sides
are fed the same seeded operation streams and must agree exactly after
every operation (picks, deficits, ``over_share``, tiers, transition
events and ``export_state``).  The envelope parsing, the tenant-label
bound and ``tenant_completions`` must match the reference's on the same
bodies.  Plain Python on both sides: no model, no device.
"""

import json
from collections import OrderedDict

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu_torch.workloads import service, tenancy

SIDES = (tenancy, jax_tenancy)


@pytest.mark.parametrize("kwargs", [
    dict(tenants=()),
    dict(tenants=("a", "a")),
    dict(tenants=("a", "")),
    dict(tenants=("a", "b"), weights=(1.0,)),
    dict(tenants=("a",), weights=(0.001,)),
    dict(tenants=("a",), prefix_pool=-1),
    dict(tenants=("a",), prefix_len=-1),
    dict(tenants=("a",), sticky_imbalance=-1),
    dict(tenants=("a",), quantum=0.0),
    dict(tenants=("a",), weights=(0.05,), quantum=0.1),
    dict(tenants=("a", "b"), ttft_slo_s=(1.0,)),
    dict(tenants=("a",), ttft_slo_s=(-1.0,)),
    dict(tenants=("a",), urgency_window_s=-1.0),
    dict(tenants=("a",), urgency_budget=-1.0),
    dict(tenants=("a",), shed_tiers=4),
    dict(tenants=("a",), staging_total=-1),
    dict(tenants=("a",), admission_shards=0),
    dict(tenants=("a",), decode_slo_s=-0.5),
], ids=["empty", "duplicate", "blank", "weight-count", "tiny-weight",
        "pool", "prefix-len", "imbalance", "quantum", "product",
        "slo-count", "slo-negative", "window", "budget", "tiers",
        "staging", "admission-shards", "decode-slo"])
def test_tenancy_config_rejections_match_the_reference(kwargs):
    messages = []
    for side in SIDES:
        with pytest.raises(ValueError) as err:
            side.TenancyConfig(**kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_tenancy_config_lookups_match_the_reference():
    kw = dict(tenants=("a", "b"), weights=(2.0, 0.5), ttft_slo_s=(0.0, 3.0))
    port, ref = (side.TenancyConfig(**kw) for side in SIDES)
    for tenant in ("a", "b", "unknown"):
        assert port.weight_of(tenant) == ref.weight_of(tenant)
        assert port.slo_of(tenant) == ref.slo_of(tenant)
        for arrived in (None, 100.0):
            assert (port.deadline_of(tenant, arrived)
                    == ref.deadline_of(tenant, arrived))


class Item:
    """A staged item: one object per side, so ``refund``'s identity
    attribution has something to hold on to."""

    def __init__(self, label: int) -> None:
        self.label = label


def labels(pairs):
    return [(tenant, item.label) for tenant, item in pairs]


def drr_stream(seed: int, n_ops: int = 220):
    """A seeded stream of DRR operations over three configured and up to
    six unknown tenants, with deadlines, picks with and without ``now``,
    refunds, pops and state round trips."""
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c"] + [f"x{i}" for i in range(6)]
    ops, now, label = [], 100.0, 0
    for _ in range(n_ops):
        now += float(rng.uniform(0.0, 0.5))
        kind = rng.choice(["push", "push", "push", "pick", "pick", "refund",
                           "over", "tail", "state"])
        if kind == "push":
            tenant = tenants[int(rng.integers(0, len(tenants)))]
            deadline = (None if rng.random() < 0.4
                        else now + float(rng.uniform(-1.0, 3.0)))
            ops.append(("push", tenant, label, deadline))
            label += 1
        elif kind == "pick":
            ops.append(("pick", int(rng.integers(0, 5)),
                        bool(rng.random() < 0.85),
                        now if rng.random() < 0.7 else None))
        elif kind == "refund":
            ops.append(("refund",))
        elif kind == "over":
            ops.append(("over", now, bool(rng.random() < 0.5)))
        elif kind == "tail":
            ops.append(("tail", tenants[int(rng.integers(0, 4))]))
        else:
            ops.append(("state",))
    return ops


def apply_drr(drr, op, last: list):
    """Apply one operation; returns what it returned, with items as
    labels.  ``last`` holds the latest pick's pairs (refund's input)."""
    if op[0] == "push":
        _, tenant, label, deadline = op
        drr.push(tenant, Item(label), deadline=deadline)
        return None
    if op[0] == "pick":
        _, k, fair, now = op
        last[:] = drr.pick(k, fair=fair, now=now)
        return labels(last)
    if op[0] == "refund":
        if not last:
            return None
        tenant, item = last.pop(0)
        drr.refund(tenant, item)
        return (tenant, item.label)
    if op[0] == "over":
        _, now, restrict = op
        popped = drr.pop_over_deadline(now, eligible={"a", "x0"}
                                       if restrict else None)
        return None if popped is None else (popped[0], popped[1].label)
    if op[0] == "tail":
        item = drr.pop_tail(op[1])
        return None if item is None else item.label
    state = drr.export_state()
    return json.loads(json.dumps(state))


DRR_CONFIGS = [
    dict(),
    dict(weights={"a": 3.0, "b": 0.5}, quantum=1.0),
    dict(weights={"a": 1.0, "b": 2.0, "c": 0.25}, quantum=2.5),
    dict(urgency_window_s=1.5, urgency_budget=2.0),
    dict(weights={"a": 4.0}, urgency_window_s=0.5, urgency_budget=1.0),
    dict(weights={"b": 0.3}, quantum=0.7, urgency_window_s=3.0,
         urgency_budget=3.0),
]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("config", range(len(DRR_CONFIGS)))
def test_drr_streams_match_the_reference_after_every_op(config, seed):
    kw = dict(DRR_CONFIGS[config])
    weights = kw.pop("weights", {})
    drrs = [side.DeficitRoundRobin(
        weight_of=lambda t, w=weights: w.get(t, 1.0),
        keep=("a", "b", "c"), **kw) for side in SIDES]
    lasts = ([], [])
    for i, op in enumerate(drr_stream(seed * 7 + config)):
        got = [apply_drr(drr, op, last) for drr, last in zip(drrs, lasts)]
        assert got[0] == got[1], f"op {i} {op}"
        port, ref = drrs
        assert port.depths() == ref.depths(), f"op {i}"
        assert port.staged == ref.staged
        assert port.urgent_picks == ref.urgent_picks
        for tenant in ("a", "b", "c", "x0", "x1"):
            assert port.deficit(tenant) == ref.deficit(tenant), f"op {i}"
        assert port.export_state() == ref.export_state(), f"op {i}"


@pytest.mark.parametrize("seed", [4, 5])
def test_drr_state_round_trip_matches_the_reference(seed):
    weights = {"a": 2.0}
    sources = [side.DeficitRoundRobin(
        weight_of=lambda t: weights.get(t, 1.0), keep=("a", "b"),
        urgency_window_s=1.0, urgency_budget=2.0) for side in SIDES]
    for op in drr_stream(seed, 80):
        for drr in sources:
            apply_drr(drr, op, [])
    state = sources[1].export_state()
    restored = [side.DeficitRoundRobin(
        weight_of=lambda t: weights.get(t, 1.0), keep=("a", "b"),
        urgency_window_s=1.0, urgency_budget=2.0) for side in SIDES]
    counts = [drr.import_state(json.loads(json.dumps(state)))
              for drr in restored]
    assert counts[0] == counts[1]
    assert restored[0].export_state() == restored[1].export_state()
    for op in drr_stream(seed + 100, 60):
        got = [apply_drr(drr, op, []) for drr in restored]
        assert got[0] == got[1]


def fair_stream(seed: int, n_ops: int = 260):
    """Stagings by a flooding tenant, two tricklers and unknown labels
    (message ids repeat, as redeliveries do), cycles, classifier reads,
    picks and gossip."""
    rng = np.random.default_rng(seed)
    ops, mid = [], 0
    for cycle in range(n_ops // 10):
        ops.append(("cycle",))
        flood = 4 if 5 <= cycle < 15 else 0
        for _ in range(flood):
            ops.append(("stage", "flood", f"m{mid}"))
            mid += 1
        for victim in ("v0", "v1"):
            if cycle % 4 == int(victim[1]):
                ops.append(("stage", victim, f"m{mid}"))
                mid += 1
        if rng.random() < 0.3:
            ops.append(("stage", f"u{int(rng.integers(0, 5))}", f"m{mid}"))
            mid += 1
        if rng.random() < 0.3 and mid:
            ops.append(("stage", "flood", f"m{int(rng.integers(0, mid))}"))
        ops.append(("over",))
        ops.append(("pick", int(rng.integers(0, 4))))
        if rng.random() < 0.05:
            ops.append(("adopt", ("v1",)))
    return ops


@pytest.mark.parametrize("seed,fair,limits", [
    (11, True, (4, 8)), (12, True, (2, 5)), (13, False, (4, 8)),
    (14, True, (8, 16)),
], ids=["drr", "tight-caps", "fifo", "loose-caps"])
def test_fair_admission_streams_match_the_reference(seed, fair, limits):
    kw = dict(tenants=("v0", "v1", "flood"), weights=(2.0, 1.0, 1.0),
              fair=fair)
    admissions = [side.FairAdmission(
        side.TenancyConfig(**kw), per_tenant_limit=limits[0],
        total_limit=limits[1]) for side in SIDES]
    label = 0
    for i, op in enumerate(fair_stream(seed)):
        got = []
        for fa in admissions:
            if op[0] == "cycle":
                got.append(fa.note_cycle())
            elif op[0] == "stage":
                got.append(fa.stage(op[1], Item(label), deadline=None,
                                    message_id=op[2]))
            elif op[0] == "over":
                got.append(sorted(fa.over_share()))
            elif op[0] == "pick":
                got.append(labels(fa.pick(op[1], now=None)))
            else:
                got.append(fa.adopt_flood(op[1]))
        label += 1
        assert got[0] == got[1], f"op {i} {op}"
        port, ref = admissions
        assert port.depths() == ref.depths()
        assert (port.staged, port.room) == (ref.staged, ref.room)
        assert port.arrival_rate == ref.arrival_rate, f"op {i}"
        assert port.export_state() == ref.export_state(), f"op {i}"
    state = json.loads(json.dumps(admissions[1].export_state()))
    fresh = [side.FairAdmission(side.TenancyConfig(**kw), per_tenant_limit=4,
                                total_limit=8) for side in SIDES]
    assert fresh[0].import_state(state) == fresh[1].import_state(state)
    assert fresh[0].export_state() == fresh[1].export_state()
    assert sorted(fresh[0].over_share()) == sorted(fresh[1].over_share())


def test_fair_admission_rejects_zero_limits_as_the_reference():
    for side in SIDES:
        with pytest.raises(ValueError, match="staging limits must be >= 1"):
            side.FairAdmission(side.TenancyConfig(tenants=("a",)),
                               per_tenant_limit=0, total_limit=4)


def pressure_stream(seed: int, n: int = 120) -> list[float]:
    """Pressures that ramp into overload, dip, spike and drain."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([np.linspace(0, 1, n // 3), np.full(n // 6, 0.8),
                           np.linspace(1, 0, n // 3), np.zeros(n // 6)])
    return list(np.clip(base + rng.normal(0, 0.12, base.size), 0, 1))


@pytest.mark.parametrize("tiers,smoothing,seed", [
    (1, 0.5, 21), (2, 0.5, 22), (3, 0.5, 23), (3, 1.0, 24), (3, 0.2, 25),
])
def test_overload_ladder_matches_the_reference(tiers, smoothing, seed):
    ladders = [side.OverloadLadder(tiers, smoothing=smoothing)
               for side in SIDES]
    for i, pressure in enumerate(pressure_stream(seed)):
        got = [ladder.update(float(pressure), now=float(i))
               for ladder in ladders]
        assert got[0] == got[1], f"step {i}"
        port, ref = ladders
        assert port.last_pressure == ref.last_pressure
        assert port.exit_threshold(max(1, port.tier)) == \
            ref.exit_threshold(max(1, ref.tier))
    port, ref = ladders
    assert port.transitions == ref.transitions > 0
    assert port.entered_total == ref.entered_total
    assert port.export_state() == ref.export_state()
    assert [(e.name, e.t, e.args) for e in port.events] == \
        [(e.name, e.t, e.args) for e in ref.events]
    assert port.trace_events() == ref.trace_events()
    state = ref.export_state()
    restored = [side.OverloadLadder(tiers) for side in SIDES]
    assert restored[0].import_state(state) == restored[1].import_state(state)
    assert restored[0].export_state() == restored[1].export_state()


@pytest.mark.parametrize("kwargs", [
    dict(tiers=0), dict(tiers=4), dict(tiers=1, smoothing=0.0),
    dict(tiers=1, thresholds=((0.5, 0.6),)),
], ids=["zero", "four", "smoothing", "thresholds"])
def test_overload_ladder_rejections_match_the_reference(kwargs):
    messages = []
    for side in SIDES:
        with pytest.raises(ValueError) as err:
            side.OverloadLadder(**kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_tenant_homes_and_pool_keys_match_the_reference():
    homes = OrderedDict([(("a", 1), 0), (("b", 2), 3), (("c", 3), 1)])
    states = [side.export_tenant_homes(homes) for side in SIDES]
    assert states[0] == states[1]
    state = {"homes": states[0]["homes"] + [["d", "x", 0], "bad"]}
    results = []
    for side in SIDES:
        live = OrderedDict([(("z", 9), 0)])
        count = side.import_tenant_homes(live, state, shards=2, limit=3)
        results.append((count, list(live.items())))
    assert results[0] == results[1]
    for ids in ([1, 2, 3], np.arange(512) % 97, []):
        for tenant in ("a", "tenant-b"):
            assert tenancy.prefix_pool_key(tenant, ids) == \
                jax_tenancy.prefix_pool_key(tenant, ids)
    assert tenancy.prefix_pool_key("a", [1]) != \
        tenancy.prefix_pool_key("b", [1])


BODIES = [
    json.dumps({"tenant": "a", "prefix": [1, 2], "ids": [3, 4, 5]}),
    json.dumps({"tenant": "b", "ids": [7]}),
    json.dumps({"ids": [1, 2]}),
    json.dumps({"tenant": "", "prefix": "nope", "ids": [9]}),
    json.dumps({"tenant": "a", "prefix": [[1], [2, 3]], "ids": [1]}),
    json.dumps({"tenant": "a", "ids": ["x"]}),
    json.dumps({"tenant": 5, "prefix": [1]}),
    json.dumps([4, 5, 6]),
    json.dumps("text"),
    "not json",
    json.dumps({"tenant": "c", "prefix": [], "ids": []}),
]


@pytest.mark.parametrize("body", BODIES, ids=[f"body{i}"
                                              for i in range(len(BODIES))])
def test_parse_tenant_request_matches_the_reference(body):
    got = service.parse_tenant_request(body, default_tenant="d")
    want = jax_service.parse_tenant_request(body, default_tenant="d")
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_tenant_label_bound_and_completions_match_the_reference():
    assert service.MAX_TENANT_SERIES == jax_service.MAX_TENANT_SERIES
    assert service.OTHER_TENANTS == jax_service.OTHER_TENANTS
    tables = ({}, {})
    for i in range(service.MAX_TENANT_SERIES + 40):
        tenant = f"t{i % (service.MAX_TENANT_SERIES + 7)}"
        keys = [fn(tenant, table) for fn, table in zip(
            (service.bounded_tenant_key, jax_service.bounded_tenant_key),
            tables)]
        assert keys[0] == keys[1]
        for table in tables:
            table[keys[0]] = table.get(keys[0], 0) + 1
    assert tables[0] == tables[1]
    assert service.OTHER_TENANTS in tables[0]
    replies = {
        "1": {"tokens": [1], "tenant": "a"},
        "2": {"tokens": [2], "tenant": "a"},
        "3": {"error": "expired", "tenant": "b"},
        "4": {"tokens": [3]},
        "5": {"tokens": [4], "tenant": 7},
        "6": {"tokens": [5], "tenant": "b"},
    }
    assert service.tenant_completions(replies) == \
        jax_service.tenant_completions(replies) == {"a": 2, "": 2, "b": 1}
