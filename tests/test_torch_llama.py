"""The port's llama family held against the JAX package's.

Weights come from the reference's ``init_llama_params`` (every matrix
widened by :data:`BOOST`, so a two-layer model's logits spread) and reach
the port through ``convert.params_from_jax``; inputs come from numpy
seeds.  Both sides run on the CPU, through dense attention (the CUDA
kernel's GQA and windowed modes are held against their plain version on
the card by ``chip_smoke.py``).  Values agree to 1e-5 (f32) and 2e-2
(bf16) of ``max(1, max|ref|)``: the same arithmetic summed in another
order, whose fp32 rounding grows with the magnitude (logits here reach
about 5).  In bf16 the port rounds where the reference's compiled program
does (see ``llama.py``), so bf16 greedy tokens are compared exactly too.
Every greedy comparison first checks that the reference's top-two logit
margin exceeds 1e-4 along its own trajectory, so a flipped token is a bug,
not a near-tie.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu_torch.workloads import decode, flash, llama
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax

from .test_torch_decode import MARGIN, top2_margin

torch.set_num_threads(1)

DIMS = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=96, max_seq_len=48)
BOOST = 10.0  # at smaller widenings greedy rollouts repeat one token
LENGTHS = np.array([20, 7, 13], np.int32)  # ragged right-padded prompts
F32_TOL = 1e-5
BF16_TOL = 2e-2


def jit(fn, *static):
    """The reference function compiled once a shape (its eager ops would
    compile one by one, several seconds a shape)."""
    return jax.jit(fn, static_argnames=static)


REF = dict(
    init=jax.jit(jax_llama.init_llama_params, static_argnums=(1,)),
    block=jit(jax_llama._llama_block, "config", "attend"),
    forward=jit(jax_llama.llama_forward, "config", "attention_fn"),
    hidden=jit(jax_llama.llama_forward_hidden, "config"),
    prefill=jit(jax_llama.llama_prefill, "config", "prompt_attention"),
    decode_step=jit(jax_llama.llama_decode_step, "config"),
    rolling_prefill=jit(jax_llama.llama_rolling_prefill, "config"),
    rolling_step=jit(jax_llama.llama_rolling_decode_step, "config"),
    generate=jit(jax_llama.llama_generate, "num_tokens", "config", "eos_id",
                 "rolling"),
    block_decode=jit(jax_decode.block_decode, "config", "step_fn"),
    cached_attention=jit(jax_decode._chunk_cached_attention, "window"),
)


def configs(dtype: str = "float32", **overrides):
    """(reference config, port config) of the same dimensions."""
    dims = {**DIMS, **overrides}
    return (jax_llama.LlamaConfig(**dims, dtype=getattr(jnp, dtype)),
            llama.LlamaConfig(**dims, dtype=getattr(torch, dtype)))


def numpy_params(jcfg, seed: int = 0, lm_head: bool = False) -> dict:
    def boost(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim != 2:
            return leaf
        return (leaf.astype(np.float32) * BOOST).astype(leaf.dtype)

    params = jax.tree.map(boost, REF["init"](jax.random.key(seed), jcfg))
    if lm_head:
        rng = np.random.default_rng(seed + 100)
        head = rng.standard_normal(params["embed"].shape) * 0.02 * BOOST
        params["lm_head"] = head.astype(params["embed"].dtype)
    return params


@functools.lru_cache(maxsize=None)
def both_params(dtype: str = "float32", seed: int = 0, lm_head=False,
                sliding_window=None):
    """(reference config, reference params, port config, port params);
    callers share them and change neither."""
    overrides = {"sliding_window": sliding_window}
    jcfg, tcfg = configs(dtype, **overrides)
    npp = numpy_params(jcfg, seed, lm_head)
    return (jcfg, jax.tree.map(jnp.asarray, npp), tcfg,
            params_from_jax(npp, tcfg, "cpu"))


def tokens(batch: int, seq: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq)).astype(np.int32)


def as_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def assert_close(got, want, dtype="float32"):
    want = as_numpy(want)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(
        as_numpy(got), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())))


def assert_cache_close(got, want, upto=None):
    for g, w in zip(got["layers"], want["layers"]):
        for name in ("k", "v"):
            assert_close(g[name][:, :, :upto],
                         np.asarray(w[name])[:, :, :upto])
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))


def test_config_validation_matches_reference():
    for bad in (dict(n_heads=8, n_kv_heads=3),
                dict(d_model=100, n_heads=8, n_kv_heads=2)):
        with pytest.raises(ValueError):
            jax_llama.LlamaConfig(**bad)
        with pytest.raises(ValueError, match="divisible"):
            llama.LlamaConfig(**bad)
    assert llama.LlamaConfig().head_dim == 64


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jax_llama._rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = llama._rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    assert_close(got, want)


@pytest.mark.parametrize("layout", ["prefill", "decode"])
def test_rope_matches_reference(layout):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 6 if layout == "prefill" else 1, 16))
    x = x.astype(np.float32)
    if layout == "prefill":  # [S]
        positions = np.arange(6, dtype=np.int32) + 5
    else:  # [B, 1, 1]: each row's own decode position
        positions = np.array([0, 17, 46], np.int32)[:, None, None]
    want_cos, want_sin = jax_llama.rope_angles(jnp.asarray(positions), 16,
                                               10_000.0)
    got_cos, got_sin = llama.rope_angles(torch.from_numpy(positions), 16,
                                         10_000.0)
    assert_close(got_cos, want_cos)
    assert_close(got_sin, want_sin)
    want = jax_llama.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                10_000.0)
    got = llama.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                           10_000.0)
    assert_close(got, want)
    # the interleaved pairs: a rotate-half layout would differ here
    half = np.concatenate([x[..., 8:], x[..., :8]], axis=-1)
    assert not np.allclose(as_numpy(got), half)


def test_llama_block_matches_reference():
    jcfg, jp, tcfg, tp = both_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    positions = np.arange(10, dtype=np.int32)
    want = REF["block"](
        jnp.asarray(x), jp["layers"][0], jcfg, jnp.asarray(positions),
        jax_llama._gqa_dense_attention(jcfg))
    rope = llama.rope_angles(torch.from_numpy(positions).long(),
                             tcfg.head_dim, tcfg.rope_theta)
    got, got32 = llama._llama_block(
        torch.from_numpy(x), tp["layers"][0], tcfg, rope,
        llama._gqa_dense_attention(tcfg))
    assert_close(got, want)
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jcfg, jp, tcfg, tp = both_params(dtype)
    ids = tokens(3, 20)
    want = REF["forward"](jp, jnp.asarray(ids), jcfg)
    got = llama.llama_forward(tp, torch.from_numpy(ids), tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 20, 128)
    assert_close(got, want, dtype)


def test_forward_hidden_matches_reference():
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(3, 20, seed=5)
    want = REF["hidden"](jp, jnp.asarray(ids), jcfg)
    got = llama.llama_forward_hidden(tp, torch.from_numpy(ids), tcfg)
    assert_close(got, want)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        llama.llama_forward(tp, torch.zeros(1, 49, dtype=torch.long), tcfg)


def test_split_layout_matches_the_fused_reference():
    # the pipeline layout (wk/wv, w_gate/w_up) computes the same values
    jcfg, jp, tcfg, tp = both_params()
    split = {**tp, "layers": []}
    for layer in tp["layers"]:
        k, v = layer["wkv"].chunk(2, dim=-1)
        gate, up = layer["w_gate_up"].chunk(2, dim=-1)
        rest = {n: t for n, t in layer.items()
                if n not in ("wkv", "w_gate_up")}
        split["layers"].append({**rest, "wk": k, "wv": v, "w_gate": gate,
                                "w_up": up})
    ids = tokens(3, 20, seed=6)
    want = REF["forward"](jp, jnp.asarray(ids), jcfg)
    assert_close(llama.llama_forward(split, torch.from_numpy(ids), tcfg),
                 want)


def test_untied_lm_head_matches_reference():
    jcfg, jp, tcfg, tp = both_params(lm_head=True)
    assert "lm_head" in tp
    assert llama.readout_weights(tp) is tp["lm_head"]
    ids = tokens(3, 20, seed=7)
    want = REF["forward"](jp, jnp.asarray(ids), jcfg)
    got = llama.llama_forward(tp, torch.from_numpy(ids), tcfg)
    assert_close(got, want)
    want, _ = REF["prefill"](jp, jnp.asarray(ids), jcfg,
                             lengths=jnp.asarray(LENGTHS))
    got, _ = llama.llama_prefill(tp, torch.from_numpy(ids), tcfg,
                                 lengths=torch.from_numpy(LENGTHS))
    assert_close(got, want)
    # the tied readout would be another function
    tied = llama.llama_forward({**tp, "lm_head": None},
                               torch.from_numpy(ids), tcfg)
    assert not np.allclose(as_numpy(tied), np.asarray(
        REF["forward"](jp, jnp.asarray(ids), jcfg)), atol=1e-2)


@pytest.mark.parametrize("window", [None, 6])
def test_prefill_logits_and_cache_match_reference(window):
    jcfg, jp, tcfg, tp = both_params(sliding_window=window)
    ids = tokens(3, 20, seed=8)
    want_logits, want_cache = REF["prefill"](
        jp, jnp.asarray(ids), jcfg, lengths=jnp.asarray(LENGTHS))
    got_logits, got_cache = llama.llama_prefill(
        tp, torch.from_numpy(ids), tcfg, lengths=torch.from_numpy(LENGTHS))
    assert_close(got_logits, want_logits)
    assert got_cache["layers"][0]["k"].shape == (3, 2, 48, 16)
    assert_cache_close(got_cache, want_cache)


def test_prefill_through_the_kernel_pick_matches_reference():
    # llama_attention_fn_for on the CPU: dense with the window bound in,
    # adapted to the compact k/v
    jcfg, jp, tcfg, tp = both_params(sliding_window=5)
    ids = tokens(2, 16, seed=9)
    pick = llama.llama_attention_fn_for(tcfg, 16, "cpu")
    want, _ = REF["prefill"](
        jp, jnp.asarray(ids), jcfg,
        prompt_attention=jax_llama.llama_attention_fn_for(jcfg, 16))
    got, _ = llama.llama_prefill(tp, torch.from_numpy(ids), tcfg,
                                 prompt_attention=pick)
    assert_close(got, want)
    full, _ = llama.llama_prefill(
        tp, torch.from_numpy(ids), tcfg,
        prompt_attention=flash.attention_fn_for(16, "cpu", tcfg.head_dim))
    assert not np.allclose(as_numpy(full), as_numpy(got), atol=1e-3)


@pytest.mark.parametrize("window", [None, 6], ids=["full", "windowed"])
def test_decode_steps_match_reference(window):
    jcfg, jp, tcfg, tp = both_params(sliding_window=window)
    ids = tokens(3, 20, seed=10)
    _, jcache = REF["prefill"](jp, jnp.asarray(ids), jcfg,
                               lengths=jnp.asarray(LENGTHS))
    _, tcache = llama.llama_prefill(tp, torch.from_numpy(ids), tcfg,
                                    lengths=torch.from_numpy(LENGTHS))
    rng = np.random.default_rng(11)
    for _ in range(4):
        step = rng.integers(0, DIMS["vocab_size"], 3).astype(np.int32)
        want, jcache = REF["decode_step"](jp, jcache,
                                          jnp.asarray(step), jcfg)
        got, tcache = llama.llama_decode_step(tp, tcache,
                                              torch.from_numpy(step), tcfg)
        assert_close(got, want)
    assert_cache_close(tcache, jcache)


def test_rolling_prefill_and_decode_match_reference():
    jcfg, jp, tcfg, tp = both_params(sliding_window=8)
    ids = tokens(3, 20, seed=12)
    want_logits, jcache = REF["rolling_prefill"](
        jp, jnp.asarray(ids), jcfg, lengths=jnp.asarray(LENGTHS))
    got_logits, tcache = llama.llama_rolling_prefill(
        tp, torch.from_numpy(ids), tcfg, lengths=torch.from_numpy(LENGTHS))
    assert_close(got_logits, want_logits)
    assert tcache["layers"][0]["k"].shape == (3, 2, 8, 16)
    assert_cache_close(tcache, jcache)
    rng = np.random.default_rng(13)
    for _ in range(10):  # row 1 (length 7) wraps its ring here
        step = rng.integers(0, DIMS["vocab_size"], 3).astype(np.int32)
        want, jcache = REF["rolling_step"](
            jp, jcache, jnp.asarray(step), jcfg)
        got, tcache = llama.llama_rolling_decode_step(
            tp, tcache, torch.from_numpy(step), tcfg)
        assert_close(got, want)
    assert_cache_close(tcache, jcache)


def test_decode_past_the_end_writes_nothing():
    # an idle serving slot at max_seq_len keeps stepping: its write drops
    _, _, tcfg, tp = both_params()
    cache = llama.init_llama_cache(tcfg, 2, "cpu")
    for layer in cache["layers"]:
        for t in layer.values():
            t.normal_(generator=torch.Generator().manual_seed(0))
    cache["length"] = torch.tensor([48, 5])
    before = [{n: t.clone() for n, t in layer.items()}
              for layer in cache["layers"]]
    logits, cache = llama.llama_decode_step(tp, cache, torch.tensor([3, 4]),
                                            tcfg)
    assert torch.isfinite(logits).all()
    for old, new in zip(before, cache["layers"]):
        for name in ("k", "v"):
            assert torch.equal(new[name][0], old[name][0])
            assert not torch.equal(new[name][1, :, 5], old[name][1, :, 5])
    assert cache["length"].tolist() == [49, 6]


def test_windowed_decode_past_the_end_stays_finite():
    # an idle windowed slot that keeps stepping far past max_seq_len still
    # attends the cache's last `window` keys: no row's softmax is empty
    _, _, tcfg, tp = both_params(sliding_window=4)
    cache = llama.init_llama_cache(tcfg, 3, "cpu")
    cache["length"] = torch.tensor([47, 48 + 3, 48 + 40])
    logits, cache = llama.llama_decode_step(
        tp, cache, torch.tensor([3, 4, 5]), tcfg)
    assert torch.isfinite(logits).all()
    assert cache["length"].tolist() == [48, 52, 89]


def reference_rollout(jcfg, jp, ids, lengths, steps, eos_id=None):
    """The reference's greedy tokens through its own prefill and decode
    steps, and the smallest top-two margin along that trajectory (rows
    already finished at ``eos_id`` excluded)."""
    logits, cache = REF["prefill"](jp, jnp.asarray(ids), jcfg,
                                   lengths=jnp.asarray(lengths))
    done = np.zeros(len(ids), bool)
    out, margins = [], []
    for step in range(steps):
        logits = np.asarray(logits, np.float32)
        margins.append(top2_margin(logits)[~done])
        token = logits.argmax(-1)
        if eos_id is not None:
            token = np.where(done, eos_id, token)
            done = done | (token == eos_id)
        out.append(token)
        if step < steps - 1:
            logits, cache = REF["decode_step"](
                jp, cache, jnp.asarray(token, jnp.int32), jcfg)
    return np.stack(out, axis=1), float(np.concatenate(margins).min())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_eos", [False, True], ids=["budget", "eos"])
def test_greedy_generate_tokens_identical_to_reference(dtype, use_eos):
    jcfg, jp, tcfg, tp = both_params(dtype)
    ids = tokens(3, 20, seed=14)
    steps = 10
    plain, _ = reference_rollout(jcfg, jp, ids, LENGTHS, steps)
    # an eos that row 0 emits mid-run, so the padding path runs
    eos_id = int(plain[0, 3]) if use_eos else None
    rollout, margin = reference_rollout(jcfg, jp, ids, LENGTHS, steps, eos_id)
    assert margin > MARGIN, f"near-tie in the reference ({margin:.2e})"
    want = np.asarray(REF["generate"](
        jp, jnp.asarray(ids), steps, jcfg, lengths=jnp.asarray(LENGTHS),
        eos_id=eos_id))
    np.testing.assert_array_equal(rollout, want)
    got = llama.llama_generate(tp, torch.from_numpy(ids), steps, tcfg,
                               lengths=torch.from_numpy(LENGTHS),
                               eos_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[1].tolist())) > 1  # not a degenerate copy
    if use_eos:
        first = list(want[0]).index(eos_id)
        assert first < steps - 1 and (want[0, first:] == eos_id).all()


def test_rolling_generate_equals_full_cache_generate():
    jcfg, jp, tcfg, tp = both_params(sliding_window=8)
    ids = tokens(3, 20, seed=15)
    lengths = torch.from_numpy(LENGTHS)
    full = llama.llama_generate(tp, torch.from_numpy(ids), 16, tcfg,
                                lengths=lengths)
    rolling = llama.llama_generate(tp, torch.from_numpy(ids), 16, tcfg,
                                   lengths=lengths, rolling=True)
    torch.testing.assert_close(rolling, full, rtol=0, atol=0)
    want = np.asarray(REF["generate"](
        jp, jnp.asarray(ids), 16, jcfg, lengths=jnp.asarray(LENGTHS),
        rolling=True))
    np.testing.assert_array_equal(rolling.numpy(), want)


def test_sampled_generate_is_reproducible_and_in_vocab():
    _, _, tcfg, tp = both_params()
    ids = torch.from_numpy(tokens(2, 10, seed=16))
    runs = [llama.llama_generate(
        tp, ids, 6, tcfg, temperature=0.8, top_k=9, top_p=0.9,
        generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert ((runs[0] >= 0) & (runs[0] < DIMS["vocab_size"])).all()


def test_block_decode_with_the_llama_step_matches_reference():
    # decode.block_decode's step_fn seam, against the reference's
    jcfg, jp, tcfg, tp = both_params(sliding_window=6)
    ids = tokens(3, 20, seed=17)
    jlogits, jcache = REF["prefill"](jp, jnp.asarray(ids), jcfg,
                                     lengths=jnp.asarray(LENGTHS))
    _, tcache = llama.llama_prefill(tp, torch.from_numpy(ids), tcfg,
                                    lengths=torch.from_numpy(LENGTHS))
    first = np.asarray(jlogits).argmax(-1)
    done = np.array([False, False, True])
    remaining = np.array([5, 2, 4])
    want = REF["block_decode"](
        jp, jcache, jnp.asarray(first, jnp.int32), jnp.asarray(done),
        jnp.asarray(remaining, jnp.int32), jnp.zeros((4, 2), jnp.uint32),
        jcfg, jax_llama.llama_decode_step)
    got = decode.block_decode(
        tp, tcache, torch.from_numpy(first).long(), torch.from_numpy(done),
        torch.from_numpy(remaining).long(), [None] * 4, tcfg,
        llama.llama_decode_step)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert_cache_close(got[0], want[0])


@pytest.mark.parametrize("heads,kv_heads,window", [
    (4, 2, None), (4, 2, 3), (4, 1, None), (2, 2, 4),
])
def test_grouped_cached_attention_matches_the_repeated_reference(
        heads, kv_heads, window):
    # the decode seam: grouped queries against the compact cache compute
    # the reference's repeat_kv attention, the window included
    rng = np.random.default_rng(18)
    q = rng.standard_normal((3, heads, 2, 16)).astype(np.float32)
    k = rng.standard_normal((3, kv_heads, 12, 16)).astype(np.float32)
    v = rng.standard_normal((3, kv_heads, 12, 16)).astype(np.float32)
    start = np.array([0, 5, 9], np.int32)
    groups = heads // kv_heads
    want = REF["cached_attention"](
        jnp.asarray(q), jax_llama.repeat_kv(jnp.asarray(k), groups),
        jax_llama.repeat_kv(jnp.asarray(v), groups), jnp.asarray(start),
        window=window)
    got = decode._chunk_cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(start).long(), window=window)
    assert_close(got, want)


@pytest.mark.parametrize("call,match", [
    ("rolling-full-cache", "window-sized cache"),
    ("rolling-cache-no-window", "sliding_window"),
    ("rolling-prefill-no-window", "sliding_window"),
    ("quantized", "do not compose"),
    ("prefix", "does not apply with prefix_cache"),
    ("zero-tokens", "num_tokens"),
    ("budget", "exceeds max_seq_len"),
    ("no-generator", "generator"),
    ("long-prompt", "exceeds max_seq_len"),
])
def test_refusals(call, match):
    _, _, tcfg, tp = both_params(sliding_window=8)
    plain = dataclasses.replace(tcfg, sliding_window=None)
    ids = torch.from_numpy(tokens(2, 10, seed=19))
    calls = {
        "rolling-full-cache": lambda: llama.llama_rolling_decode_step(
            tp, llama.llama_prefill(tp, ids, tcfg)[1], ids[:, 0], tcfg),
        "rolling-cache-no-window": lambda: llama.init_llama_rolling_cache(
            plain, 2, "cpu"),
        "rolling-prefill-no-window": lambda: llama.llama_rolling_prefill(
            tp, ids, plain),
        # int8 and the prefix are ported (test_torch_int8_cache,
        # test_torch_prefix): the rolling ring with int8, and a prompt
        # attention beside a prefix, are what is refused
        "quantized": lambda: llama.llama_generate(
            tp, ids, 2, tcfg, rolling=True, quantized_cache=True),
        "prefix": lambda: llama.llama_generate(
            tp, ids, 2, tcfg, prompt_attention=llama._gqa_dense_attention(
                tcfg),
            prefix_cache=llama.llama_prefill_prefix(tp, ids[0, :3], tcfg)),
        "zero-tokens": lambda: llama.llama_generate(tp, ids, 0, tcfg),
        "budget": lambda: llama.llama_generate(tp, ids, 39, tcfg),
        "no-generator": lambda: llama.llama_generate(tp, ids, 2, tcfg,
                                                     temperature=1.0),
        "long-prompt": lambda: llama.llama_prefill(
            tp, torch.zeros(1, 49, dtype=torch.long), tcfg),
    }
    with pytest.raises(ValueError, match=match):
        calls[call]()


def test_init_and_convert_carry_the_reference_layout():
    jcfg, tcfg = configs()
    want = REF["init"](jax.random.key(0), jcfg)
    got = llama.init_llama_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    assert sorted(got) == sorted(want)
    for g, w in zip(got["layers"], want["layers"]):
        assert {n: tuple(t.shape) for n, t in g.items()} == \
            {n: tuple(t.shape) for n, t in w.items()}
        assert (g["attn_norm"] == 1).all() and (g["mlp_norm"] == 1).all()
    no_mlp = llama.init_llama_params(tcfg, torch.Generator().manual_seed(0),
                                     "cpu", dense_mlp=False)
    assert "w_gate_up" not in no_mlp["layers"][0]
    # the built-in llama's size: the reference binary's config
    full = llama.init_llama_params(llama.LlamaConfig(max_seq_len=544),
                                   torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for n, t in full.items() if n != "layers") + sum(
        t.numel() for layer in full["layers"] for t in layer.values()
    ) == 15_471_104
    jbf, tbf = configs("bfloat16")
    converted = params_from_jax(numpy_params(jbf, lm_head=True), tbf, "cpu")
    assert converted["lm_head"].dtype == torch.bfloat16
    assert converted["layers"][0]["wkv"].shape == (64, 64)
