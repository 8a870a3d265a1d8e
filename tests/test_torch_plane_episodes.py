"""The host dynamics of ``chip_smoke.py``'s ``planes`` episodes, on the CPU.

The phase's waits in engine cycles, sticky homes, spills, pool installs,
admission-shard hand-backs and the prefill kill's cycle are host
bookkeeping: every request decodes its full 32 tokens, so they do not
depend on the weights or the width.  These tests drive the phase's own
episode functions (``tenant_episode``, ``disagg_episode``) at the
built-in models' depth, context and traffic, with d_model 32 in f32, and
pin the numbers the card reads at full width.  The decode plane's
drafted episodes depend on the draft's acceptance, which is the
weights', so only their exactly-once delivery is held here.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import chip_smoke as smoke
from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
from kube_sqs_autoscaler_tpu_torch.workloads import flash
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import BUILTIN_CONFIGS
from kube_sqs_autoscaler_tpu_torch.workloads.admission_shards import HashRing
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import TenancyConfig

torch.set_num_threads(1)


def narrow(family: str, prefix_len: int, headroom: int = 0):
    """The built-in model of ``family`` at its depth and context, d_model
    32, f32, weights from seed 0 on the CPU."""
    config = BUILTIN_CONFIGS[family](512, 32, prefix_len, headroom)
    widths = dict(d_model=32, n_heads=2, d_ff=64, dtype=torch.float32)
    if family == "llama":
        widths["n_kv_heads"] = 1
    config = dataclasses.replace(config, **widths)
    return config, family_of(config).init_params(
        config, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def tenant_setup():
    bodies = smoke.tenant_bodies(smoke.flood_schedule(),
                                 smoke.tenant_prefixes())
    return bodies, narrow("gpt", smoke.TENANT_PREFIX)


def homes_and_spills(run):
    first, spills = {}, {}
    for tenant, shard, home in run["admissions"]:
        first.setdefault(tenant, home)
        if shard != home:
            spills[tenant] = spills.get(tenant, 0) + 1
    return first, spills


@pytest.mark.parametrize("fair, wait, homes, spills, installs", [
    (True, 0.75, {"victim0": 0, "victim1": 1, "flood": 2}, {"flood": 43}, 6),
    (False, 0.95, {"victim0": 0, "victim1": 1, "flood": 0},
     {"victim0": 2, "flood": 44}, 7),
], ids=["drr", "fifo"])
def test_flood_on_the_plane(tenant_setup, fair, wait, homes, spills,
                            installs):
    bodies, (config, params) = tenant_setup
    tenancy = TenancyConfig(tenants=smoke.TENANTS,
                            prefix_pool=smoke.POOL_ENTRIES,
                            prefix_len=smoke.TENANT_PREFIX, fair=fair)
    run = smoke.tenant_episode(torch, flash, params, config, bodies,
                               tenancy, shards=smoke.PLANE_SHARDS,
                               device="cpu")
    assert len(run["replies"]) == len(run["sent"]) == 84
    assert run["duplicates"] == 0
    assert run["completed_by_tenant"] == {"victim0": 10, "victim1": 10,
                                          "flood": 64}
    assert run["victim_wait_cycles"] == pytest.approx(wait, abs=1e-9)
    assert homes_and_spills(run) == (homes, spills)
    assert run["homes"] == homes
    assert run["pool"]["installs"] == installs
    assert run["pool"]["evictions"] == 0
    assert run["cycles"] == 42


def test_admission_shard_kill_mid_flood(tenant_setup):
    bodies, (config, params) = tenant_setup
    flood_shard = HashRing(4).shard_of("flood")
    other = (flood_shard + 1) % 4
    plan = FleetFaultPlan(admission_kills=((9, flood_shard),),
                          admission_partitions=((6, 14, other),))
    tenancy = TenancyConfig(tenants=smoke.TENANTS,
                            prefix_pool=smoke.POOL_ENTRIES,
                            prefix_len=smoke.TENANT_PREFIX,
                            admission_shards=4)
    run = smoke.tenant_episode(torch, flash, params, config, bodies,
                               tenancy, shards=smoke.PLANE_SHARDS,
                               plan=plan, device="cpu")
    fair = run["fair"]
    killed = fair.shards[flood_shard]
    handed = sum(e.args["handed_back"] for e in fair.events
                 if e.name == "admission-kill")
    assert flood_shard == 3
    assert len(run["replies"]) == len(run["sent"]) == 84
    assert run["duplicates"] == 0
    assert run["completed_by_tenant"] == {"victim0": 10, "victim1": 10,
                                          "flood": 64}
    assert (killed.kills, killed.rehydrations) == (1, 1)
    assert handed == 10
    assert killed.rehydrated_records == 2


@pytest.fixture(scope="module")
def disagg_setup():
    bodies = smoke.disagg_bodies(smoke.disagg_schedule())
    return bodies, narrow("gpt", 0, 2 * smoke.SPEC_K)


def delivered_once(run) -> None:
    assert len(run["replies"]) == len(run["sent"]) == run["processed"] == 72
    assert run["duplicates"] == 0
    assert run["queue"]["ApproximateNumberOfMessages"] == "0"
    assert run["queue"]["ApproximateNumberOfMessagesNotVisible"] == "0"
    assert run["first_token_seen"] == 72


def test_prefill_kill_on_the_plain_decode_plane(disagg_setup):
    bodies, (config, params) = disagg_setup
    run = smoke.disagg_episode(torch, flash, params, config, bodies,
                               fused=False, kill=True, plain_decode=True,
                               device="cpu")
    delivered_once(run)
    assert run["killed"] == (13, 0, 3)
    assert run["redispatched"] == 3
    assert run["prefill_inserts"] == 37
    assert run["handoff"]["rows"] == run["kv_handoffs"] == 72
    assert run["handoff"]["launches"] == 0
    assert run["draft_inserts"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "disagg"])
def test_wave_drain_answers_once(disagg_setup, fused):
    bodies, (config, params) = disagg_setup
    run = smoke.disagg_episode(torch, flash, params, config, bodies,
                               fused=fused, device="cpu")
    delivered_once(run)
    if not fused:
        assert run["prefill_inserts"] == 36
        assert run["handoff"]["rows"] == run["kv_handoffs"] == 72
        assert run["handoff"]["launches"] == 0
