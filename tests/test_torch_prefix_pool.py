"""The port's per-tenant prefix pool held against the JAX package's.

Both families (the GPT and the llama's compact GQA cache) and both cache
layouts (full precision and int8 codes with scales), with the reference's
weights converted by ``convert.params_from_jax``.  The same keys in the
same order give the same pool rows, hits, misses, installs, evictions
and residency, through LRU eviction, ``evict_cold`` and ``set_capacity``,
on one partition and on two; the stacked rows equal the reference pool's
within 1e-5 of ``max(1, max|ref|)`` in f32 and the int8 codes are equal.
The reference pool's one-time prefill is run jitted here (the compiled
program is what the port matches bit for bit; eager JAX divides by 127
where the compiled program multiplies by its reciprocal).  Its argument
checks fail with the reference's messages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu_torch.workloads import tenancy

from .test_torch_prefix import LAYOUT_IDS, LAYOUTS, name
from .test_torch_quantize import assert_close, ref, tokens, weights

torch.set_num_threads(1)

PREFIX = 8


@pytest.fixture(autouse=True)
def jitted_reference_prefill(monkeypatch):
    def prefill_entry(self, prefix_ids):
        build = ref(self.family, name("prefill_prefix", self.quantized_kv))
        return build(self.params, jnp.asarray(prefix_ids), config=self.config)

    monkeypatch.setattr(jax_tenancy.PrefixPool, "_prefill_entry",
                        prefill_entry)


def both_pools(family, quantized, **kw):
    jcfg, jp, tcfg, tp = weights(family)
    port = tenancy.PrefixPool(tp, tcfg, prefix_len=PREFIX, family=family,
                              quantized_kv=quantized, device="cpu", **kw)
    reference = jax_tenancy.PrefixPool(jp, jcfg, prefix_len=PREFIX,
                                       family=family, quantized_kv=quantized,
                                       **kw)
    return port, reference


def prefixes(family, n: int) -> dict:
    """Tenant -> prefix ids; tenants t0 and t1 share one prefix (their
    entries stay separate), t2 rotates to a second prefix."""
    out = {f"t{i}": tokens(family, 1, PREFIX, seed=300 + i)[0]
           for i in range(n)}
    out["t1"] = out["t0"]
    out["t2b"] = tokens(family, 1, PREFIX, seed=399)[0]
    return out


def assert_rows_equal(port, reference):
    for got_layer, want_layer in zip(port.layers, reference.layers):
        assert got_layer.keys() == want_layer.keys()
        for leaf, got in got_layer.items():
            want = np.asarray(want_layer[leaf])
            if leaf.endswith("codes"):
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert_close(got, want)


def assert_same_state(port, reference, where):
    assert port.stats() == reference.stats(), where
    for shard in range(port.shards):
        assert port.resident_keys(shard) == reference.resident_keys(shard), \
            where


@pytest.mark.parametrize("family,quantized", LAYOUTS, ids=LAYOUT_IDS)
def test_pool_rows_and_counters_match_the_reference(family, quantized):
    port, reference = both_pools(family, quantized, entries=3)
    ids = prefixes(family, 5)
    # hits, installs, LRU evictions, a rotated prefix and shared content
    script = ["t0", "t1", "t0", "t2", "t3", "t0", "t2b", "t4", "t1",
              ("evict", 1), "t3", "t0", ("capacity", 2), "t4", "t4", "t2",
              ("capacity", 3), "t1", "t0"]
    for step, op in enumerate(script):
        if isinstance(op, tuple):
            kind, n = op
            got = [getattr(p, "evict_cold" if kind == "evict"
                           else "set_capacity")(n) for p in (port, reference)]
        else:
            tenant = op.removesuffix("b")
            key = tenancy.prefix_pool_key(tenant, ids[op])
            assert key == jax_tenancy.prefix_pool_key(tenant, ids[op])
            got = [p.acquire(0, key, ids[op]) for p in (port, reference)]
            assert port.resident(0, key) and reference.resident(0, key)
        assert got[0] == got[1], f"step {step} {op}"
        assert_same_state(port, reference, f"step {step} {op}")
    assert port.installs > 3 and port.evictions > 2 and port.hits > 2
    assert_rows_equal(port, reference)


@pytest.mark.parametrize("family,quantized", [("gpt", False),
                                              ("llama", True)],
                         ids=["gpt", "llama-int8"])
def test_pool_partitions_per_shard_match_the_reference(family, quantized):
    port, reference = both_pools(family, quantized, entries=2, shards=2)
    ids = prefixes(family, 4)
    for step, (shard, tenant) in enumerate(
            [(0, "t0"), (1, "t0"), (1, "t3"), (0, "t2"), (1, "t2"),
             (1, "t0"), (0, "t3"), (0, "t0")]):
        key = tenancy.prefix_pool_key(tenant, ids[tenant])
        got = [p.acquire(shard, key, ids[tenant]) for p in (port, reference)]
        assert got[0] == got[1], f"step {step}"
        assert_same_state(port, reference, f"step {step}")
    assert port.evict_cold(1) == reference.evict_cold(1) > 0
    assert_same_state(port, reference, "evict")
    assert_rows_equal(port, reference)


def test_pool_install_events_match_the_reference():
    port, reference = both_pools("gpt", False, entries=1)
    ids = prefixes("gpt", 4)
    for tenant in ("t0", "t3", "t0"):
        key = tenancy.prefix_pool_key(tenant, ids[tenant])
        for pool in (port, reference):
            pool.acquire(0, key, ids[tenant])
    names = [[(e.name, e.args) for e in pool.events]
             for pool in (port, reference)]
    assert names[0] == names[1]
    assert [e["name"] for e in port.trace_events()] == \
        ["prefix-install", "prefix-evict", "prefix-install", "prefix-evict",
         "prefix-install"]
    assert {e["cat"] for e in port.trace_events()} == {"prefix"}


@pytest.mark.parametrize("make,call", [
    (dict(entries=0), None),
    (dict(entries=2, prefix_len=0), None),
    (dict(entries=2, prefix_len=10_000), None),
    (dict(entries=2, shards=0), None),
    (dict(entries=2), ("acquire", 0, [1, 2, 3])),
    (dict(entries=2), ("acquire", 5, None)),
    (dict(entries=2), ("set_capacity", 3)),
    (dict(entries=2), ("evict_cold", -1)),
], ids=["entries", "prefix-len", "past-context", "shards", "off-bucket",
        "shard-range", "capacity", "evict"])
def test_pool_checks_fail_as_the_reference(make, call):
    messages = []
    for side, (cfg, params) in ((tenancy, weights("gpt")[2:]),
                                (jax_tenancy, weights("gpt")[:2])):
        kw = {"prefix_len": PREFIX, **make}
        extra = {"device": "cpu"} if side is tenancy else {}
        with pytest.raises(ValueError) as err:
            pool = side.PrefixPool(params, cfg, **kw, **extra)
            method, *args = call
            if method == "acquire":
                shard, ids = args
                ids = np.arange(PREFIX) if ids is None else ids
                pool.acquire(shard, ("a", 0), ids)
            else:
                getattr(pool, method)(*args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
