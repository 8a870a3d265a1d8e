"""The cached decode attention's plain version
(``decode._chunk_cached_attention`` at one position a row), its routing
and the kernel wrapper's refusals, on the CPU (the kernel itself runs only
on the card, where ``chip_smoke.py`` holds it against the plain version).

The plain version is held against the JAX package's ``_cached_attention``
on the same numpy inputs in f32, for the GPT's multi-head layout and the
llama's grouped one, with and without a window, over one ragged batch that
holds every kind of row a serving cache has.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu_torch.workloads import (
    decode, decode_attn, llama, model,
)

REF = jax.jit(jax_decode._cached_attention, static_argnames=("window",))

KEYS = 40
WINDOW = 8
# one ragged batch: a never-used slot, mid-cache, the cache's last
# position, an idle slot stepping on past the end, and a row whose window
# starts well inside the cache
LENGTHS = [0, 17, KEYS - 1, KEYS + 3, 33]
FAMILIES = {
    "gpt-mha-d64": (4, 4, 64),
    "llama-gqa-32-over-8-d128": (32, 8, 128),
}


def inputs(heads, kv_heads, dim, seed=24):
    rng = np.random.default_rng(seed)
    batch = len(LENGTHS)
    q = rng.standard_normal((batch, heads, 1, dim)).astype(np.float32)
    k = rng.standard_normal((batch, kv_heads, KEYS, dim)).astype(np.float32)
    v = rng.standard_normal((batch, kv_heads, KEYS, dim)).astype(np.float32)
    return q, k, v, np.array(LENGTHS, np.int64)


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_version_matches_the_reference(family, window):
    heads, kv_heads, dim = FAMILIES[family]
    q, k, v, length = inputs(heads, kv_heads, dim)
    groups = heads // kv_heads
    # past the end the port's window stops at the cache's last key (the
    # reference has no such clamp): such a row is the reference's row at
    # the last position; without a window the raw length is the same row
    ref_length = length if window is None else np.minimum(length, KEYS - 1)
    want = REF(jnp.asarray(q), jax_llama.repeat_kv(jnp.asarray(k), groups),
               jax_llama.repeat_kv(jnp.asarray(v), groups),
               jnp.asarray(ref_length), window=window)
    args = [torch.from_numpy(a) for a in (q, k, v, length)]
    got = decode._chunk_cached_attention(*args, window)
    assert got.shape == (len(LENGTHS), heads, 1, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the decode step's seam computes the same on the CPU, bit for bit
    assert torch.equal(decode._cached_attention(*args, window=window), got)


@pytest.mark.parametrize("device,query_len,q_dtype,cache_dtype,dim,want", [
    ("cuda", 1, torch.bfloat16, torch.bfloat16, 64, True),
    ("cuda", 1, torch.bfloat16, torch.bfloat16, 128, True),
    ("cuda:0", 1, torch.float32, torch.float32, 64, True),
    ("cuda", 1, torch.float32, torch.float32, 128, True),
    ("cpu", 1, torch.bfloat16, torch.bfloat16, 64, False),
    ("cpu", 1, torch.float32, torch.float32, 128, False),
    ("meta", 1, torch.bfloat16, torch.bfloat16, 64, False),
    ("cuda", 4, torch.bfloat16, torch.bfloat16, 64, False),  # T > 1
    ("cuda", 1, torch.bfloat16, torch.int8, 64, False),  # int8 codes
    ("cuda", 1, torch.float16, torch.float16, 64, False),
    ("cuda", 1, torch.bfloat16, torch.float32, 64, False),
    ("cuda", 1, torch.bfloat16, torch.bfloat16, 16, False),
    ("cuda", 1, torch.bfloat16, torch.bfloat16, 96, False),
])
def test_routing_predicate(device, query_len, q_dtype, cache_dtype, dim,
                           want):
    assert decode_attn.takes_kernel(torch.device(device), query_len, q_dtype,
                                    cache_dtype, dim) is want


def gpt_setup():
    config = model.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                               n_layers=2, d_ff=64, max_seq_len=16,
                               dtype=torch.float32)
    params = model.init_params(config, torch.Generator().manual_seed(0),
                               device="cpu")
    return config, params


def llama_setup(**overrides):
    config = llama.LlamaConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=64,
                               max_seq_len=16, dtype=torch.float32,
                               **overrides)
    params = llama.init_llama_params(config, torch.Generator().manual_seed(0),
                                     device="cpu")
    return config, params


def run_path(path):
    """One decode of ``path`` on a 2-layer model after a 4-token prompt;
    returns the model's layer count."""
    prompt = torch.tensor([[3, 5, 7, 9], [2, 4, 6, 8]])
    step = torch.tensor([11, 12])
    if path in ("gpt", "gpt-chunk", "gpt-int8"):
        config, params = gpt_setup()
        if path == "gpt-int8":
            _, cache = decode.quantized_prefill(params, prompt, config)
            decode.quantized_decode_step(params, cache, step, config)
        else:
            _, cache = decode.prefill(params, prompt, config)
            if path == "gpt":
                decode.decode_step(params, cache, step, config)
            else:
                decode.chunk_decode(params, cache, prompt[:, :3], config)
        return config.n_layers
    config, params = llama_setup(sliding_window=4 if path == "llama-rolling"
                                 else None)
    if path == "llama-rolling":
        _, cache = llama.llama_rolling_prefill(params, prompt, config)
        llama.llama_rolling_decode_step(params, cache, step, config)
    elif path == "llama-int8":
        _, cache = llama.llama_quantized_prefill(params, prompt, config)
        llama.llama_quantized_decode_step(params, cache, step, config)
    else:
        _, cache = llama.llama_prefill(params, prompt, config)
        if path == "llama":
            llama.llama_decode_step(params, cache, step, config)
        else:
            llama.llama_chunk_decode(params, cache, prompt[:, :3], config)
    return config.n_layers


@pytest.mark.parametrize("path,routed", [
    ("gpt", True), ("llama", True),
    ("gpt-chunk", False), ("llama-chunk", False),
    ("gpt-int8", False), ("llama-int8", False), ("llama-rolling", False),
])
def test_only_the_one_position_full_cache_step_reaches_the_kernel(
        monkeypatch, path, routed):
    # with the predicate forced on, a call site that reaches the kernel
    # calls decode_attention once a layer; the chunk (T > 1), int8 and
    # rolling attentions never call it
    calls = []

    def record(q, k_cache, v_cache, length, window=None):
        calls.append((tuple(q.shape), k_cache.dtype, window))
        return decode._chunk_cached_attention(q, k_cache, v_cache, length,
                                              window)

    monkeypatch.setattr(decode_attn, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(decode_attn, "decode_attention", record)
    layers = run_path(path)
    assert len(calls) == (layers if routed else 0)
    assert all(shape[2] == 1 for shape, _, _ in calls)


@pytest.mark.parametrize("keys,pairs,sms,want", [
    (1024, 224 * 25, 132, (1, 1024)),  # GPT-2 XL, 224 slots: one chunk
    (4109, 80 * 8, 132, (7, 640)),  # Mistral-7B, 80 slots of 4109
    (4096, 8, 132, (16, 256)),  # one row: chunks no shorter than 256
    (100, 1, 132, (1, 128)),
    (4097, 64, 132, (17, 256)),
])
def test_split_comes_from_the_shapes(keys, pairs, sms, want):
    chunks, chunk_len = decode_attn.split(keys, pairs, sms)
    assert (chunks, chunk_len) == want
    assert chunk_len % 64 == 0
    assert (chunks - 1) * chunk_len < keys <= chunks * chunk_len


def meta(shape, dtype=torch.bfloat16, **kw):
    return torch.empty(shape, dtype=dtype, device="meta", **kw)


def refusal_inputs(case):
    q = torch.zeros((2, 4, 1, 64))
    k = torch.zeros((2, 2, 16, 64))
    length = torch.zeros(2, dtype=torch.long)
    window = None
    if case == "q-3d":
        q = q[:, :, 0]
    elif case == "two-positions":
        q = torch.zeros((2, 4, 2, 64))
    elif case == "kv-differ":
        return q, k, k[:, :, :8], length, window
    elif case == "batch":
        k = torch.zeros((3, 2, 16, 64))
    elif case == "heads":
        k = torch.zeros((2, 3, 16, 64))
    elif case == "length-dtype":
        length = length.int()
    elif case == "length-shape":
        length = torch.zeros((2, 1), dtype=torch.long)
    elif case == "window":
        window = 0
    elif case == "cpu":
        pass
    elif case == "meta":
        q, k, length = meta(q.shape), meta(k.shape), meta((2,), torch.long)
    elif case == "mixed-devices":
        q, k = meta(q.shape), meta(k.shape)
    elif case == "dtype":
        q, k = meta(q.shape, torch.float16), meta(k.shape, torch.float16)
    elif case == "dtypes-differ":
        q, k = meta(q.shape), meta(k.shape, torch.float32)
    elif case == "head-dim":
        q, k = meta((2, 4, 1, 32)), meta((2, 2, 16, 32))
    elif case == "last-dim":
        q = meta((2, 4, 1, 64))
        k = meta((2, 2, 64, 16)).transpose(2, 3)
    elif case == "misaligned":
        q = meta(q.shape)
        k = torch.empty_strided((2, 2, 16, 64), (2 * 16 * 68, 16 * 68, 68, 1),
                                dtype=torch.bfloat16, device="meta")
    return q, k, k, length, window


@pytest.mark.parametrize("case,match", [
    ("q-3d", r"q must be \[B, H, S, D\]"),
    ("two-positions", "one position a row, got 2"),
    ("kv-differ", "differ"),
    ("batch", "does not match"),
    ("heads", "not divisible by kv heads 3"),
    ("length-dtype", "length must be int64"),
    ("length-shape", "length must be int64"),
    ("window", "window=0 must be >= 1"),
    ("cpu", "one CUDA device"),
    ("meta", "one CUDA device"),
    ("mixed-devices", "one CUDA device"),
    ("dtype", "bf16 or f32"),
    ("dtypes-differ", "bf16 or f32"),
    ("head-dim", "head dim 32 not supported"),
    ("last-dim", "contiguous in their last dim"),
    ("misaligned", "16-byte boundaries"),
])
def test_wrapper_refusals(case, match):
    # the wrapper launches the kernel or raises, on the CPU too; meta
    # tensors reach the kernel's checks past the shapes'
    q, k, v, length, window = refusal_inputs(case)
    with pytest.raises(ValueError, match=match):
        decode_attn.decode_attention(q, k, v, length, window=window)


def test_cpu_calls_never_count_as_launches():
    before = decode_attn.decode_attention_launches
    q, k, v, length = (torch.from_numpy(a) for a in inputs(4, 4, 64))
    decode._cached_attention(q, k, v, length, window=WINDOW)
    config, params = gpt_setup()
    _, cache = decode.prefill(params, torch.tensor([[1, 2, 3]]), config)
    decode.decode_step(params, cache, torch.tensor([4]), config)
    assert decode_attn.decode_attention_launches == before


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("family", FAMILIES)
def test_chip_smoke_check_holds_each_row_to_one_output_rounding(family,
                                                                window):
    # the card's check, on the CPU: the f32 plain version rounded once to
    # bf16 (what the kernel computes) passes; the plain version in bf16,
    # which rounds its probabilities before the value product, and the
    # answer with one key off are refused
    heads, kv_heads, dim = FAMILIES[family]
    q, k, v, length = (torch.from_numpy(a) for a in inputs(heads, kv_heads,
                                                             dim))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    exact = decode._chunk_cached_attention(q.float(), k.float(), v.float(),
                                           length, window)
    check = chip_smoke.decode_attn_check(
        torch, exact.bfloat16(), q, k, v, length, window, "bfloat16")
    assert check["ratio"] <= 1
    assert check["control"] > 1
    assert check["control_rows"] == 3  # rows 17, KEYS - 1 and 33
    plain_bf16 = decode._chunk_cached_attention(q, k, v, length, window)
    assert chip_smoke.decode_attn_check(
        torch, plain_bf16, q, k, v, length, window, "bfloat16")["ratio"] > 1


def test_chip_smoke_counts_decode_launches_by_phase(monkeypatch):
    smoke = chip_smoke.Smoke()

    def launch(n):
        decode_attn.decode_attention_launches += n

    def outer():
        launch(2)
        smoke.phase("inner", launch, 3)
        launch(1)

    monkeypatch.setattr(decode_attn, "decode_attention_launches", 10)
    smoke.phase("outer", outer)
    smoke.phase("none", lambda: None)
    assert smoke.decode_launches == {"outer": 3, "inner": 3}
    assert not smoke.failures
