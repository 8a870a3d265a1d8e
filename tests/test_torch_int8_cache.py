"""The port's int8 KV cache and chunk decoder held against the JAX package's.

The same weights and numpy inputs go through the reference's jitted
``quantize_kv``, int8 prefill, decode step, chunk decoders and generate and
through the port, for both families (the llama also with a window of 6), on
the CPU.  ``quantize_kv`` codes and scales are bitwise equal; f32 logits
within 1e-5 of ``max(1, max|ref|)``; greedy tokens equal up to the first
near-tie (``test_torch_quantize``'s guards).  The continuous batcher (blocks
1 and 3, refills mid-stream) and a 2-shard plane run int8 slots against the
reference's, tokens and host transfers compared after every step.  Also
here: the two repairs the int8 layout carries (an out-of-range write is
dropped, as the reference's scatter drops it; a windowed idle slot past the
end stays finite) and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu_torch.workloads import (
    continuous, decode, llama, shard_plane,
)
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

from .test_torch_quantize import (
    BF16_GUARD, MARGIN, as_numpy, assert_close, assert_tokens_upto_ties, ref,
    reference_rollout, tokens, weights,
)
from .test_torch_shard_plane import step_both

LENGTHS = np.array([12, 5, 9], np.int32)
CASES = [("gpt", None), ("llama", None), ("llama", 6)]
CASE_IDS = ["gpt", "llama", "llama-window"]


def assert_int8_cache_close(got, want):
    """Scales within 1e-5; codes equal but for a rare one-step difference
    (the k/v they quantize agree to fp32 rounding, which can cross a
    rounding boundary), so the dequantized values agree within one step."""
    for g, w in zip(got["layers"], want["layers"]):
        for kind in ("k", "v"):
            gc = as_numpy(g[f"{kind}_codes"])
            wc = np.asarray(w[f"{kind}_codes"], np.float32)
            ws = np.asarray(w[f"{kind}_scale"])
            assert_close(g[f"{kind}_scale"], ws)
            off = np.abs(gc - wc)
            assert off.max() <= 1 and off.mean() < 1e-3
            gd = gc * as_numpy(g[f"{kind}_scale"])[..., None]
            assert (np.abs(gd - wc * ws[..., None])
                    <= ws[..., None] * 1.001 + 1e-6).all()
    np.testing.assert_array_equal(as_numpy(got["length"]),
                                  np.asarray(want["length"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise_equal_to_the_jitted_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 3, 7, 16)) * 2).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero vector takes the floor scale
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_codes, want_scale = jax.jit(jax_decode.quantize_kv)(jx)
    got_codes, got_scale = decode.quantize_kv(
        torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype)))
    assert got_scale.shape == (2, 3, 7)
    assert np.array_equal(got_codes.numpy(), np.asarray(want_codes))
    assert np.array_equal(got_scale.numpy(), np.asarray(want_scale))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_empty_int8_cache_is_the_references(family):
    jcfg, _, tcfg, _ = weights(family)
    layout = family_of(tcfg).layout(quantized_kv=True)
    got = layout.init_cache(tcfg, 3, "cpu")
    heads = tcfg.n_kv_heads if family == "llama" else None
    want = jax_decode.init_quantized_cache(jcfg, 3, kv_heads=heads)
    for g, w in zip(got["layers"], want["layers"]):
        assert sorted(g) == sorted(w)
        for name in g:
            assert g[name].dtype == {"int8": torch.int8,
                                     "float32": torch.float32}[
                str(w[name].dtype)]
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))


@pytest.mark.parametrize("family,window", CASES, ids=CASE_IDS)
def test_quantized_prefill_and_decode_steps_match_reference(family, window):
    jcfg, jp, tcfg, tp = weights(family, window=window)
    layout = family_of(tcfg).layout(quantized_kv=True)
    ids = tokens(family, 3, 12, seed=6)
    want, jcache = ref(family, "quantized_prefill")(
        jp, jnp.asarray(ids), config=jcfg, lengths=jnp.asarray(LENGTHS))
    got, tcache = layout.prefill(tp, torch.from_numpy(ids), tcfg, None,
                                 lengths=torch.from_numpy(LENGTHS))
    assert_close(got, want)
    assert tcache["layers"][0]["k_codes"].dtype == torch.int8
    assert_int8_cache_close(tcache, jcache)
    rng = np.random.default_rng(7)
    for _ in range(3):
        step = rng.integers(0, tcfg.vocab_size, 3).astype(np.int32)
        want, jcache = ref(family, "quantized_decode_step")(
            jp, jcache, jnp.asarray(step), config=jcfg)
        got, tcache = layout.decode_step(tp, tcache, torch.from_numpy(step),
                                         tcfg)
        assert_close(got, want)
    assert_int8_cache_close(tcache, jcache)


@pytest.mark.parametrize("family,window", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("quantized", [False, True], ids=["full", "int8"])
def test_chunk_decode_matches_reference(family, window, quantized):
    jcfg, jp, tcfg, tp = weights(family, window=window)
    layout = family_of(tcfg).layout(quantized)
    prefill = "quantized_prefill" if quantized else "prefill"
    chunk = "quantized_chunk_decode" if quantized else "chunk_decode"
    ids = tokens(family, 3, 12, seed=8)
    _, jcache = ref(family, prefill)(jp, jnp.asarray(ids), config=jcfg,
                                     lengths=jnp.asarray(LENGTHS))
    _, tcache = layout.prefill(tp, torch.from_numpy(ids), tcfg, None,
                               lengths=torch.from_numpy(LENGTHS))
    more = tokens(family, 3, 4, seed=9)
    want, jcache = ref(family, chunk)(jp, jcache, jnp.asarray(more),
                                      config=jcfg)
    got, tcache = layout.chunk_decode(tp, tcache, torch.from_numpy(more),
                                      tcfg)
    assert got.shape == (3, 4, tcfg.vocab_size)
    assert_close(got, want)
    np.testing.assert_array_equal(tcache["length"].numpy(), LENGTHS + 4)
    if quantized:
        assert_int8_cache_close(tcache, jcache)
    else:
        for g, w in zip(tcache["layers"], jcache["layers"]):
            assert_close(g["k"], w["k"])
            assert_close(g["v"], w["v"])
    # the chunk equals T single steps (the keys land in the same slots)
    _, steps_cache = layout.prefill(tp, torch.from_numpy(ids), tcfg, None,
                                    lengths=torch.from_numpy(LENGTHS))
    for t in range(4):
        stepped, steps_cache = layout.decode_step(
            tp, steps_cache, torch.from_numpy(more[:, t]), tcfg)
        assert_close(stepped, got[:, t])


@pytest.mark.parametrize("family,dtype,int8_weights", [
    ("gpt", "float32", False), ("llama", "float32", False),
    ("gpt", "bfloat16", False), ("llama", "bfloat16", True),
], ids=["gpt-f32", "llama-f32", "gpt-bf16", "llama-bf16-int8w"])
def test_quantized_generate_matches_reference(family, dtype, int8_weights):
    jcfg, jp, tcfg, tp = weights(family, dtype, int8=int8_weights)
    ids = tokens(family, 3, 12, seed=10)
    steps = 8
    want = np.asarray(ref(family, "generate")(
        jp, jnp.asarray(ids), num_tokens=steps, config=jcfg,
        lengths=jnp.asarray(LENGTHS), quantized_cache=True))
    rollout, margins = reference_rollout(
        lambda: ref(family, "quantized_prefill")(
            jp, jnp.asarray(ids), config=jcfg, lengths=jnp.asarray(LENGTHS)),
        lambda cache, token: ref(family, "quantized_decode_step")(
            jp, cache, token, config=jcfg),
        steps)
    np.testing.assert_array_equal(rollout, want)
    got = family_of(tcfg).generate(tp, torch.from_numpy(ids), steps, tcfg,
                                   None, lengths=torch.from_numpy(LENGTHS),
                                   quantized_cache=True)
    guard = MARGIN if dtype == "float32" else BF16_GUARD[family]
    assert_tokens_upto_ties(got.numpy(), want, margins, guard)


# ---------------------------------------------------------------------------
# The carried repairs
# ---------------------------------------------------------------------------


def port_cache(jcache) -> dict:
    """The reference's cache as the port's, every entry exact."""
    return {
        "layers": [{name: torch.from_numpy(np.array(leaf))
                    for name, leaf in layer.items()}
                   for layer in jcache["layers"]],
        "length": torch.from_numpy(np.array(jcache["length"])).long(),
    }


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_out_of_range_int8_and_chunk_writes_drop_like_the_reference(family):
    # rows whose positions run past max_seq_len, from the same cache on
    # both sides: a decode step writes nothing there, and a chunk
    # straddling the end keeps its in-range part (the reference's scatter
    # drops the rest)
    jcfg, jp, tcfg, tp = weights(family)
    end = tcfg.max_seq_len
    ids = tokens(family, 3, 12, seed=11)
    for quantized in (True, False):
        layout = family_of(tcfg).layout(quantized)
        prefill = "quantized_prefill" if quantized else "prefill"
        names = (("quantized_decode_step", "quantized_chunk_decode")
                 if quantized else ("decode_step", "chunk_decode"))
        _, jcache = ref(family, prefill)(jp, jnp.asarray(ids), config=jcfg)
        jcache = dict(jcache, length=jnp.asarray([end - 2, end, end + 3],
                                                 jnp.int32))
        tcache = port_cache(jcache)
        step = tokens(family, 3, 1, seed=12)[:, 0]
        want, jcache = ref(family, names[0])(jp, jcache, jnp.asarray(step),
                                             config=jcfg)
        got, tcache = layout.decode_step(tp, tcache, torch.from_numpy(step),
                                         tcfg)
        assert_close(got[:1], want[:1])  # the in-range row's logits
        # a 4-token chunk from end - 1: one position lands, three drop
        jcache = dict(jcache, length=jnp.full((3,), end - 1, jnp.int32))
        tcache["length"] = torch.full((3,), end - 1, dtype=torch.long)
        chunk = tokens(family, 3, 4, seed=13)
        want, jcache = ref(family, names[1])(jp, jcache, jnp.asarray(chunk),
                                             config=jcfg)
        got, tcache = layout.chunk_decode(tp, tcache,
                                          torch.from_numpy(chunk), tcfg)
        assert_close(got[:, 0], want[:, 0])
        if quantized:
            assert_int8_cache_close(tcache, jcache)
        else:
            for g, w in zip(tcache["layers"], jcache["layers"]):
                assert_close(g["k"], w["k"])
                assert_close(g["v"], w["v"])


def test_windowed_int8_idle_slot_past_the_end_stays_finite():
    # the window's lower edge stops at the cache's last key in the int8
    # attention too (the reference has no clamp: its slot would go NaN)
    _, _, tcfg, tp = weights("llama", window=4)
    layout = family_of(tcfg).layout(quantized_kv=True)
    ids = torch.from_numpy(tokens("llama", 2, 12, seed=14))
    _, cache = layout.prefill(tp, ids, tcfg, None)
    cache["length"] = torch.tensor([tcfg.max_seq_len + 9, 12])
    token = ids[:, 0]
    for _ in range(3):
        logits, cache = layout.decode_step(tp, cache, token, tcfg)
        assert torch.isfinite(logits).all()
        token = logits.argmax(-1)
    # sampled serving steps it on too: the multinomial never sees a NaN
    batcher = continuous.ContinuousBatcher(
        tp, tcfg, batch_size=2, prompt_len=12, generate_tokens=5,
        temperature=0.8, top_k=20, sample_seed=3, decode_block=1,
        quantized_kv=True, device="cpu")
    done = []
    for i in range(14):
        batcher.submit_many([(tokens("llama", 1, 8, seed=20 + i)[0], i)])
        while batcher.active:
            done += [j for j, _ in batcher.step()]
    assert done == list(range(14))
    assert int(batcher.cache["length"][1]) > tcfg.max_seq_len + 4


def test_rolling_and_int8_refuse_to_compose():
    _, _, tcfg, tp = weights("llama", window=6)
    ids = torch.from_numpy(tokens("llama", 2, 8, seed=15))
    with pytest.raises(ValueError, match="do not compose"):
        llama.llama_generate(tp, ids, 2, tcfg, rolling=True,
                             quantized_cache=True)


# ---------------------------------------------------------------------------
# The continuous batcher and the sharded plane on int8 slots
# ---------------------------------------------------------------------------


def counters(batcher) -> tuple[int, int, int]:
    return (batcher.insert_dispatches, batcher.decode_dispatches,
            batcher.host_transfers)


def reference_greedy(family, requests, steps, prompt_len=12):
    """The reference's greedy int8-cache tokens for each prompt alone
    (rows of one right-padded batch), its margins checked."""
    jcfg, jp, _, _ = weights(family)
    ids = np.zeros((len(requests), prompt_len), np.int32)
    for row, prompt in enumerate(requests):
        ids[row, :len(prompt)] = prompt
    lengths = jnp.asarray([len(p) for p in requests], jnp.int32)
    want, margins = reference_rollout(
        lambda: ref(family, "quantized_prefill")(
            jp, jnp.asarray(ids), config=jcfg, lengths=lengths),
        lambda cache, token: ref(family, "quantized_decode_step")(
            jp, cache, token, config=jcfg),
        steps)
    assert margins.min() > MARGIN
    return want


def int8_prompts(family, n, seed):
    rng = np.random.default_rng(seed)
    return [tokens(family, 1, int(rng.integers(2, 13)), seed=seed + i)[0]
            for i in range(n)]


@pytest.mark.parametrize("family,decode_block", [("gpt", 1), ("llama", 3)])
def test_int8_batcher_matches_the_reference_batcher(family, decode_block):
    jcfg, jp, tcfg, tp = weights(family)
    requests = int8_prompts(family, 7, seed=30)
    knobs = dict(batch_size=3, prompt_len=12, generate_tokens=5,
                 decode_block=decode_block, family=family, quantized_kv=True)
    port = continuous.ContinuousBatcher(tp, tcfg, device="cpu", **knobs)
    reference = jax_continuous.ContinuousBatcher(jp, jcfg, **knobs)
    assert port.cache["layers"][0]["k_codes"].dtype == torch.int8
    waiting, got, refills = list(enumerate(requests)), {}, 0
    for step in range(200):
        free = len(port.free_slots)
        assert free == len(reference.free_slots)
        if waiting and free and step % 2 == 0:
            take = min(free, 2)  # refills of 1-2 while other slots decode
            for batcher in (port, reference):
                batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
            refills += port.active > take
        done = {i: np.asarray(t).tolist() for i, t in port.step()}
        assert done == {i: np.asarray(t).tolist()
                        for i, t in reference.step()}
        got.update(done)
        assert counters(port) == counters(reference), f"step {step}"
        if not waiting and port.active == 0:
            break
    assert refills > 0 and sorted(got) == list(range(7))
    want = reference_greedy(family, requests, 5)
    for i in range(7):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{i}")


@pytest.mark.parametrize("family", ["llama"])
def test_int8_plane_matches_the_reference_plane(family):
    jcfg, jp, tcfg, tp = weights(family)
    knobs = dict(shards=2, shard_slots=2, prompt_len=12, generate_tokens=5,
                 decode_block=2, family=family, quantized_kv=True)
    port = shard_plane.ShardedBatcher(tp, tcfg, device="cpu", **knobs)
    reference = jax_plane.ShardedBatcher(jp, jcfg, **knobs)
    requests = int8_prompts(family, 7, seed=40)
    waiting, results = list(enumerate(requests)), {}
    for step in range(60):
        free = len(port.free_slots)
        assert free == len(reference.free_slots)
        take = min(free, 3 if step % 3 == 0 else 0)
        if waiting and take:
            batch = [(ids, i) for i, ids in waiting[:take]]
            waiting = waiting[take:]
            assert port.submit_many(batch) == reference.submit_many(batch)
        step_both(port, reference, results)
        if not waiting and port.active == 0:
            break
    assert sorted(results) == list(range(7))
    want = reference_greedy(family, requests, 5)
    for i in range(7):
        np.testing.assert_array_equal(results[i], want[i], err_msg=f"{i}")


def test_resume_insert_on_int8_slots_continues_the_request():
    # an evacuated row re-admitted mid-request through the resume insert
    # (prompt + produced, its unspent budget) ends with the uninterrupted
    # request's tokens
    _, _, tcfg, tp = weights("gpt")
    knobs = dict(shards=2, shard_slots=2, prompt_len=12, generate_tokens=5,
                 decode_block=1, quantized_kv=True, device="cpu")
    plane = shard_plane.ShardedBatcher(tp, tcfg, **knobs)
    ids = int8_prompts("gpt", 1, seed=50)[0]
    whole = reference_greedy("gpt", [ids], 5)[0]
    plane.submit_many([(ids, "a")])
    plane.step()
    plane.step()
    (payload, produced, budget, submitted), = plane.take_shard_inflight(0)
    assert 0 < len(produced) < budget
    plane.submit_resume([(ids, payload, produced, budget, submitted)])
    done = []
    while plane.active:
        done += plane.step()
    assert done[0][0] == "a"
    np.testing.assert_array_equal(done[0][1], whole)
