"""The port's sharded serving plane held against the JAX package's.

The same weights (the reference's ``init_params``, converted) and the same
numpy prompts go through ``kube_sqs_autoscaler_tpu.workloads`` and the
port, f32 and greedy on the CPU:

- ``block_decode``'s fault seams (``freeze``, ``corrupt``, ``health``) and
  ``gang_block_decode`` at 1, 2 and 3 shards with eos, scale, poison and
  wedge masks: equal tokens (a poisoned row's are garbage and skipped),
  counts, ``free`` and ``bad``; sampled shards draw their own streams;
- ``ShardedBatcher`` against the reference's on one staggered stream,
  after every step: the row each request routes to, the dispatch,
  transfer and scan counters and the replies, with refills that split
  across shards, a masked shard finishing its rows, a probing shard's cap
  and the memoized availability invalidated at every change;
- ``submit_resume`` at block and budget edges, ``set_slot_limit`` and
  ``request_decode_block``.

Every greedy comparison first checks that the reference's top-two logit
margin exceeds 1e-4 (``reference_greedy``), so a flipped token is a bug.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu_torch.workloads import decode, shard_plane
from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
    ContinuousBatcher,
)

from .test_torch_continuous import _prefill, prompts, reference_greedy
from .test_torch_model import DIMS, both_params

SHARDS, SLOTS, PROMPT, TOKENS, BLOCK = 3, 2, 12, 5, 2
ROWS = 6  # every direct decode test's batch: one compile of each shape


@pytest.fixture(scope="module")
def weights():
    return both_params()


def as_np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# block_decode's seams and gang_block_decode
# ---------------------------------------------------------------------------


def prefilled(weights, seed: int):
    """:data:`ROWS` ragged prompts prefilled on both sides, their greedy
    trajectories checked for near-ties; returns (the reference cache, the
    port cache, the first greedy tokens, the trajectories)."""
    jcfg, jp, tcfg, tp = weights
    requests = prompts(ROWS, seed=seed, max_len=10)
    trajectory = reference_greedy(jcfg, jp, requests, BLOCK + 2, width=10)
    ids = np.zeros((ROWS, 10), np.int32)
    for row, prompt in enumerate(requests):
        ids[row, :len(prompt)] = prompt
    lengths = np.array([len(p) for p in requests], np.int32)
    logits, jcache = _prefill(jp, jnp.asarray(ids), config=jcfg,
                              lengths=jnp.asarray(lengths))
    _, tcache = decode.prefill(tp, torch.from_numpy(ids), tcfg,
                               lengths=torch.from_numpy(lengths))
    current = np.asarray(logits).argmax(-1).astype(np.int32)
    return jcache, tcache, current, trajectory


def port_state(current, done, remaining):
    return (torch.from_numpy(current.astype(np.int64)),
            torch.from_numpy(done.copy()),
            torch.from_numpy(remaining.astype(np.int64)))


@pytest.mark.parametrize("seams", ["freeze", "corrupt", "health", "all"])
def test_block_decode_seams_match_reference(weights, seams):
    jcfg, jp, tcfg, tp = weights
    jcache, tcache, current, _ = prefilled(weights, seed=21)
    done = np.array([False, False, True, False, False, False])
    remaining = np.array([3, 3, 3, 1, 3, 2], np.int32)
    freeze = np.array([False, True, False, False, False, False])
    corrupt = np.array([False, False, False, True, False, False])
    kw = {}
    if seams in ("freeze", "all"):
        kw["freeze"] = freeze
    if seams in ("corrupt", "all"):
        kw["corrupt"] = corrupt
    want = jax_decode.block_decode(
        jp, jcache, jnp.asarray(current), jnp.asarray(done),
        jnp.asarray(remaining), jnp.zeros((3, 2), jnp.uint32), jcfg,
        health=seams != "freeze",
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = decode.block_decode(
        tp, tcache, *port_state(current, done, remaining), [None] * 3, tcfg,
        health=seams != "freeze",
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert len(got) == len(want) == (6 if seams == "freeze" else 7)
    clean = ~corrupt if "corrupt" in kw else np.ones(ROWS, bool)
    np.testing.assert_array_equal(as_np(got[4])[:, clean],
                                  as_np(want[4])[:, clean])  # tokens
    np.testing.assert_array_equal(as_np(got[5]), as_np(want[5]))  # counts
    if seams != "freeze":
        np.testing.assert_array_equal(as_np(got[6]), as_np(want[6]))  # bad
        assert bool(as_np(got[6])[3]) == ("corrupt" in kw)
    if "freeze" in kw:
        assert as_np(got[5])[1] == 0


def test_sampled_corrupt_rows_never_reach_multinomial(weights):
    # a sampled pick over NaN logits raises in torch.multinomial (a
    # device-side assert on the card): the poisoned row picks from a
    # stand-in, its NaN still flagged
    _, _, tcfg, tp = weights
    _, tcache, current, _ = prefilled(weights, seed=3)
    keys = [torch.Generator().manual_seed(i) for i in range(2)]
    corrupt = torch.arange(ROWS) == 0
    got = decode.block_decode(
        tp, tcache, *port_state(current, np.zeros(ROWS, bool),
                                np.full(ROWS, 4, np.int32)),
        keys, tcfg, temperature=1.0, corrupt=corrupt, health=True)
    assert as_np(got[6]).tolist() == corrupt.tolist()
    assert as_np(got[5]).tolist() == [2] * ROWS


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_gang_block_decode_matches_reference(weights, shards):
    jcfg, jp, tcfg, tp = weights
    rows = ROWS
    slots = rows // shards
    jcache, tcache, current, trajectory = prefilled(weights, seed=shards)
    # eos: what row 0 emits at its second block step fires early there
    eos = int(trajectory[0, 2])
    done = np.zeros(rows, bool)
    done[max(2, slots - 1)] = True  # an idle slot
    remaining = np.full(rows, 4, np.int32)
    remaining[1] = 1  # runs out of budget mid-block
    active = np.ones(shards, bool)
    poison = np.zeros(shards, bool)
    wedge = np.zeros(shards, bool)
    if shards >= 2:
        poison[1] = True
    if shards >= 3:
        wedge[2] = True
        active[2] = False
    keys = jnp.zeros((BLOCK, 2), jnp.uint32)
    want = jax_decode.gang_block_decode(
        jp, jcache, jnp.asarray(current), jnp.asarray(done),
        jnp.asarray(remaining), keys, jnp.asarray(active), jcfg,
        shards=shards, eos_id=eos, poison=jnp.asarray(poison),
        wedge=jnp.asarray(wedge))
    got = decode.gang_block_decode(
        tp, tcache, *port_state(current, done, remaining), [None] * BLOCK,
        torch.from_numpy(active), tcfg, shards=shards, eos_id=eos,
        poison=torch.from_numpy(poison), wedge=torch.from_numpy(wedge))
    clean = ~np.repeat(poison, slots)
    for name, index in (("current", 1), ("done", 2), ("remaining", 3)):
        np.testing.assert_array_equal(as_np(got[index])[clean],
                                      as_np(want[index])[clean], name)
    assert as_np(got[4]).shape == (BLOCK, rows)
    np.testing.assert_array_equal(as_np(got[4])[:, clean],
                                  as_np(want[4])[:, clean])
    for name, index in (("counts", 5), ("free", 6), ("bad", 7)):
        np.testing.assert_array_equal(as_np(got[index]), as_np(want[index]),
                                      name)
    counts, free, bad = (as_np(got[i]) for i in (5, 6, 7))
    # row 0 stops at eos, row 1 at its budget
    assert counts[0] <= 2 and bool(as_np(got[2])[0]) and counts[1] == 1
    assert bad.tolist() == poison.tolist()
    if shards >= 3:
        assert free[2] == 0 and counts[2 * slots:].sum() == 0  # masked, wedged


def test_gang_shards_draw_their_own_samples(weights):
    # one generator a step draws for every row: two shards given the same
    # prompt do not replay one stream (the reference folds the shard into
    # its keys for this)
    _, _, tcfg, tp = weights
    ids = np.tile(prompts(1, seed=5, max_len=10)[0], (2, 1))
    _, tcache = decode.prefill(tp, torch.from_numpy(ids), tcfg)
    current = torch.zeros(2, dtype=torch.long)
    keys = [torch.Generator().manual_seed(i) for i in range(8)]
    out = decode.gang_block_decode(
        tp, tcache, current, torch.zeros(2, dtype=torch.bool),
        torch.full((2,), 8), keys, torch.ones(2, dtype=torch.bool), tcfg,
        shards=2, temperature=1.0)
    tokens = as_np(out[4])
    assert tokens.shape == (8, 2)
    assert not np.array_equal(tokens[:, 0], tokens[:, 1])


# ---------------------------------------------------------------------------
# ShardedBatcher against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_donor(weights):
    """One reference plane whose compiled programs every reference plane
    of this module adopts, so each compiles once."""
    return make_planes(weights)[1]


def make_planes(weights, donor=None, **kw):
    jcfg, jp, tcfg, tp = weights
    knobs = dict(shards=SHARDS, shard_slots=SLOTS, prompt_len=PROMPT,
                 generate_tokens=TOKENS, decode_block=BLOCK, **kw)
    port = shard_plane.ShardedBatcher(tp, tcfg, device="cpu", **knobs)
    ref = jax_plane.ShardedBatcher(jp, jcfg, **knobs)
    if donor is not None:
        ref.adopt_engine(donor)
    return port, ref


def snapshot(plane) -> dict:
    return {
        "insert_dispatches": plane.insert_dispatches,
        "decode_dispatches": plane.decode_dispatches,
        "gang_cycles": plane.gang_cycles,
        "host_transfers": plane.host_transfers,
        "summary_transfers": plane.summary_transfers,
        "free_slot_scans": plane.free_slot_scans,
        "tokens_emitted": plane.tokens_emitted,
        "block_tokens": plane.block_tokens,
        "block_capacity": plane.block_capacity,
        "shard_tokens": list(plane.shard_tokens),
        "busy": [plane.shard_busy(s) for s in range(plane.shards)],
        "stall": list(plane.shard_stall_cycles),
        "progress": list(plane.shard_last_progress),
        "free_summary": (None if plane.last_free_summary is None
                         else np.asarray(plane.last_free_summary).tolist()),
        "bad": (None if plane.last_health_bad is None
                else np.asarray(plane.last_health_bad).tolist()),
        "mismatch": list(plane.mask_mismatch),
    }


def step_both(port, ref, results) -> None:
    out = []
    for plane in (port, ref):
        out.append({payload: np.asarray(tokens).tolist()
                    for payload, tokens in plane.step()})
    assert out[0] == out[1]
    results.update(out[0])
    assert snapshot(port) == snapshot(ref)


def test_plane_matches_reference_plane_after_every_step(weights, jax_donor):
    jcfg, jp, _, _ = weights
    port, ref = make_planes(weights, donor=jax_donor)
    requests = prompts(13, seed=17)
    want = reference_greedy(jcfg, jp, requests, TOKENS)
    # (step, requests admitted): refills of 1-4 while other slots decode,
    # so refills split across shards
    schedule = {0: 3, 1: 1, 2: 4, 5: 2, 7: 3}
    waiting = list(enumerate(requests))
    results, routed = {}, []
    masked_busy = None
    for step in range(80):
        free = len(port.free_slots)
        assert free == len(ref.free_slots)
        take = min(schedule.get(step, len(waiting) if step > 9 else 0),
                   free)
        if take:
            batch = [(ids, i) for i, ids in waiting[:take]]
            waiting = waiting[take:]
            rows = port.submit_many(batch)
            assert rows == ref.submit_many(batch)
            routed.append(rows)
        if step == 3:
            # scale down shard 2: it admits nothing, its rows finish
            masked_busy = port.shard_busy(2)
            for plane in (port, ref):
                plane.set_shard_active(2, False)
        if step == 9:
            for plane in (port, ref):
                plane.set_shard_active(2, True)
        if 3 <= step < 9:
            assert all(row // SLOTS != 2 for row in port.free_slots)
            ref.free_slots  # the same scan on both sides
        step_both(port, ref, results)
        if not waiting and port.active == 0 and step > 9:
            break
    assert masked_busy and port.shard_busy(2) == 0
    assert routed[0] == [0, 2, 4]  # one per shard, lowest shard on ties
    assert any(len({row // SLOTS for row in rows}) > 1 for rows in routed[1:])
    assert sorted(results) == list(range(len(requests)))
    for i in range(len(requests)):
        np.testing.assert_array_equal(results[i], want[i], err_msg=f"{i}")
    # one gang dispatch per busy cycle, one transfer per cycle at most
    assert port.decode_dispatches == port.gang_cycles
    assert port.summary_transfers == port.block_settles


def test_admission_cache_invalidates_on_every_eligibility_change(
        weights, jax_donor):
    port, ref = make_planes(weights, donor=jax_donor)
    ids = prompts(4, seed=2)

    def same_availability():
        got = port._admission_rows_by_shard()
        assert port._admission_rows_by_shard() is got  # memoized
        assert got == ref._admission_rows_by_shard()
        assert port.free_slots == ref.free_slots
        return got

    assert same_availability() == [[0, 1], [2, 3], [4, 5]]
    for plane in (port, ref):
        plane.submit_many([(ids[0], "a")])  # slot assignment
    assert same_availability() == [[1], [2, 3], [4, 5]]
    for plane in (port, ref):
        plane.set_shard_active(1, False)  # mask flip
    assert same_availability() == [[1], [], [4, 5]]
    for plane in (port, ref):
        plane.shard_probing[2] = True  # an in-place write: half-open cap
    assert same_availability() == [[1], [], [4]]
    for plane in (port, ref):
        plane.set_slot_limit(1)  # the slot-limit knob
    assert same_availability() == [[], [], [4]]
    for plane in (port, ref):
        plane.set_slot_limit(None)
        plane.shard_probing[2] = False
        plane.set_shard_active(1, True)
    assert same_availability() == [[1], [2, 3], [4, 5]]
    results = {}
    while port.active:  # slot release
        step_both(port, ref, results)
    assert same_availability() == [[0, 1], [2, 3], [4, 5]]
    assert port.free_slot_scans == ref.free_slot_scans


def test_plane_adopts_a_sharded_donor_only(weights):
    _, _, tcfg, tp = weights
    port, _ = make_planes(weights)
    plain = ContinuousBatcher(tp, tcfg, SHARDS * SLOTS, PROMPT, TOKENS,
                              decode_block=BLOCK, device="cpu")
    with pytest.raises(ValueError, match="sharded donor only"):
        port.adopt_engine(plain)
    other = shard_plane.ShardedBatcher(
        tp, tcfg, shards=SHARDS, shard_slots=SLOTS, prompt_len=PROMPT,
        generate_tokens=TOKENS, decode_block=BLOCK, device="cpu")
    other.adopt_engine(port)
    assert other._gang_fn is port._gang_fn
    with pytest.raises(ValueError, match="shards=0"):
        shard_plane.ShardedBatcher(tp, tcfg, shards=0, shard_slots=2,
                                   prompt_len=PROMPT, generate_tokens=2,
                                   device="cpu")
    # a mesh is ported: the reference's refusal of shards its data axis
    # does not divide
    with pytest.raises(ValueError, match="not divisible by the mesh's "
                       "data axis"):
        shard_plane.ShardedBatcher(
            tp, tcfg, shards=2, shard_slots=2, prompt_len=PROMPT,
            generate_tokens=2, device="cpu",
            mesh=SimpleNamespace(shape={"data": 4, "seq": 1, "model": 1}))


# ---------------------------------------------------------------------------
# The resume insert and the live knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [BLOCK, TOKENS - 1],
                         ids=["block-boundary", "budget-edge"])
def test_submit_resume_matches_reference(weights, jax_donor, cut):
    # a resume cut at a block boundary, and one short of the budget, where
    # the resume insert's first token is the request's last
    jcfg, jp, _, _ = weights
    ids = prompts(1, seed=23)[0]
    expected = reference_greedy(jcfg, jp, [ids], TOKENS)[0].tolist()
    port, ref = make_planes(weights, donor=jax_donor)
    for plane in (port, ref):
        plane.set_shard_active(0, False)  # quarantine stand-in
        assert plane.submit_resume(
            [(ids, "resumed", expected[:cut], TOKENS, 0.0)]) == [2]
    results = {}
    while port.active or ref.active:
        step_both(port, ref, results)
    assert results["resumed"] == expected
    assert port.insert_dispatches == 1


def test_evacuated_row_resumes_byte_identical(weights, jax_donor):
    jcfg, jp, _, _ = weights
    ids = prompts(1, seed=29)[0]
    expected = reference_greedy(jcfg, jp, [ids], TOKENS)[0].tolist()
    port, ref = make_planes(weights, donor=jax_donor)
    results = {}
    for plane in (port, ref):
        assert plane.submit_many([(ids, "c")]) == [0]
    for _ in range(2):
        step_both(port, ref, results)
    taken = [plane.take_shard_inflight(0) for plane in (port, ref)]
    assert [t[:3] for t in taken[0]] == [t[:3] for t in taken[1]]
    assert len(taken[0]) == 1
    payload, produced, budget, submitted_at = taken[0][0]
    assert 0 < len(produced) < budget
    for plane in (port, ref):
        assert plane.shard_busy(0) == 0
        plane.set_shard_active(0, False)
        plane.submit_resume([(ids, payload, produced, budget, submitted_at)])
    assert snapshot(port) == snapshot(ref)
    while port.active or ref.active:
        step_both(port, ref, results)
    assert results["c"] == expected


def test_submit_resume_validates(weights):
    _, _, tcfg, tp = weights
    port, _ = make_planes(weights)
    ids = prompts(1)[0]
    assert port.resume_len == PROMPT + TOKENS
    with pytest.raises(ValueError, match="does not resume"):
        port.submit_resume([(ids, "p", list(range(TOKENS)), TOKENS, 0.0)])
    too_many = [(ids, f"p{i}", [1], TOKENS, 0.0)
                for i in range(len(port.slots) + 1)]
    with pytest.raises(RuntimeError, match="no free slot"):
        port.submit_resume(too_many)
    assert port.insert_dispatches == 0 and port.submit_resume([]) == []


def test_slot_limit_and_decode_block_knobs_match_reference(
        weights, jax_donor):
    jcfg, jp, _, _ = weights
    port, ref = make_planes(weights, donor=jax_donor)
    requests = prompts(8, seed=31)
    want = reference_greedy(jcfg, jp, requests, TOKENS)
    for plane in (port, ref):
        plane.set_slot_limit(1)  # one busy row per shard
    with pytest.raises(ValueError, match="slot_limit"):
        port.set_slot_limit(SLOTS + 1)
    waiting = list(enumerate(requests))
    results = {}
    for step in range(60):
        free = len(port.free_slots)
        assert free == len(ref.free_slots)
        if waiting and free:
            batch = [(ids, i) for i, ids in waiting[:free]]
            waiting = waiting[free:]
            assert port.submit_many(batch) == ref.submit_many(batch)
        if step == 2:
            # staged: the next step dispatches nothing, its block settles
            assert [p.request_decode_block(3) for p in (port, ref)] == \
                [True, True]
            assert port.request_decode_block(3) is False
        if step == 4:
            for plane in (port, ref):
                plane.set_slot_limit(None)
        step_both(port, ref, results)
        assert port.decode_block == ref.decode_block
        if not waiting and port.active == 0:
            break
    assert port.decode_block == 3
    assert port.gang_cycles < port.summary_transfers + 2
    for i in range(len(requests)):
        np.testing.assert_array_equal(results[i], want[i], err_msg=f"{i}")


def test_plain_block_engine_takes_the_decode_block_knob(weights):
    jcfg, jp, tcfg, tp = weights
    requests = prompts(3, seed=37)
    want = reference_greedy(jcfg, jp, requests, TOKENS)
    batcher = ContinuousBatcher(tp, tcfg, 3, PROMPT, TOKENS, decode_block=2,
                                device="cpu")
    single = ContinuousBatcher(tp, tcfg, 3, PROMPT, TOKENS, device="cpu")
    with pytest.raises(ValueError, match="live knob"):
        single.request_decode_block(2)
    batcher.submit_many([(ids, i) for i, ids in enumerate(requests)])
    results = dict(batcher.step())
    assert batcher.request_decode_block(1)
    dispatches = batcher.decode_dispatches
    results.update(batcher.step())  # the re-dispatch boundary: no dispatch
    assert batcher.decode_dispatches == dispatches
    assert batcher.decode_block == 1
    while batcher.active:
        results.update(batcher.step())
    for i in range(3):
        np.testing.assert_array_equal(results[i], want[i])


def test_a_slot_readmitted_before_the_stale_block_settles_keeps_its_tokens(
        weights):
    # a row evacuated while its block is in flight, on a plane left with
    # nothing busy: the block stays unsettled until a new request takes
    # the row, and it must not hand that request the old one's tokens
    jcfg, jp, tcfg, tp = weights
    first, second = prompts(2, seed=41)
    want = reference_greedy(jcfg, jp, [second], TOKENS)[0].tolist()
    plane = shard_plane.ShardedBatcher(
        tp, tcfg, shards=2, shard_slots=1, prompt_len=PROMPT,
        generate_tokens=TOKENS, decode_block=BLOCK, device="cpu")
    plane.set_shard_active(1, False)
    assert plane.submit_many([(first, "old")]) == [0]
    plane.step()
    plane.step()  # block 2 in flight, holding the old request's tokens
    assert len(plane.take_shard_inflight(0)) == 1
    assert plane.active == 0 and plane.step() == []
    assert plane.submit_many([(second, "new")]) == [0]
    results = {}
    while plane.active:
        results.update(plane.step())
    assert np.asarray(results["new"]).tolist() == want
