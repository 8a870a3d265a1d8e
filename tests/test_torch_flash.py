"""The port's flash attention held against the JAX package's Pallas kernel.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version
(the CUDA kernel runs only on the card and is checked there by
``chip_smoke.py``); the reference runs its real kernel in Pallas interpret
mode, as ``tests/test_flash.py`` does.  Tolerances: f32 atol 1e-5 (the
same fp32 arithmetic summed in another order), bf16 atol 2e-2 (bf16
outputs, one rounding step is ~4e-3 at magnitude 1, and the two sides
round the probabilities at different running maxima).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads.flash import flash_attention as jax_flash
from kube_sqs_autoscaler_tpu_torch.workloads import flash
from kube_sqs_autoscaler_tpu_torch.workloads.model import _dense_attention

# these tests are tiny, and the suite runs in several pytest workers that
# share the CPU: one intra-op thread each keeps torch from oversubscribing it
torch.set_num_threads(1)

# (batch, heads, kv_heads, seq, head_dim, causal, window)
CASES = {
    "causal-s128": (2, 2, 2, 128, 32, True, None),
    "causal-s64": (1, 2, 2, 64, 64, True, None),
    "gqa-h4-kv2": (1, 4, 2, 128, 32, True, None),
    "window16": (1, 2, 2, 128, 32, True, 16),
    "full": (1, 2, 2, 64, 32, False, None),
}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def qkv(batch, heads, kv_heads, seq, dim, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, seq, dim)).astype(np.float32)
    k = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    v = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_matches_reference_kernel(case, dtype):
    batch, heads, kv_heads, seq, dim, causal, window = CASES[case]
    q, k, v = qkv(batch, heads, kv_heads, seq, dim)
    want = np.asarray(jax_flash(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
        causal=causal, window=window, interpret=True,
    ), np.float32)
    got = flash.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=causal, window=window,
    )
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (batch, heads, seq, dim)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=0)


def test_reference_version_matches_dense_attention_with_window():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 2, 48, 32, seed=2))
    for window in (None, 1, 5, 48):
        torch.testing.assert_close(
            flash.flash_attention_reference(q, k, v, window=window),
            _dense_attention(q, k, v, window=window), atol=1e-5, rtol=0,
        )


def test_gqa_adapt_and_windowed_match_the_native_paths():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 4, 2, 32, 32, seed=3))
    dense = flash.gqa_adapt(flash.windowed(_dense_attention, 8))
    native = flash.gqa_adapt(flash.windowed(flash.flash_attention, 8))
    assert native.gqa_native and not getattr(dense, "gqa_native", False)
    torch.testing.assert_close(dense(q, k, v), native(q, k, v), atol=1e-5,
                               rtol=0)
    assert flash.windowed(flash.flash_attention, None) is flash.flash_attention
    assert torch.equal(flash.repeat_kv(k, 2)[:, 3], k[:, 1])


def test_attention_fn_for_picks_the_kernel_on_cuda_and_dense_on_cpu():
    for seq in (16, 48, 512, 4096):
        assert flash.attention_fn_for(seq, "cuda") is flash.flash_attention
        assert flash.attention_fn_for(seq, "cpu") is _dense_attention
    assert flash.attention_fn_for(64, torch.device("cuda", 0)) is \
        flash.flash_attention


def test_cpu_calls_never_count_as_kernel_launches():
    before = flash.kernel_launches
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 2, 16, 64))
    flash.flash_attention(q, k, v)
    assert flash.kernel_launches == before


def test_non_cpu_tensors_never_run_the_plain_version():
    # tensors that are not on the CPU launch the kernel or raise: on a
    # device that is not CUDA the wrapper raises before any launch
    q = torch.empty((1, 2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, q, q)


@pytest.mark.parametrize("bad,match", [
    (dict(window=8, causal=False), "requires causal"),
    (dict(window=0), ">= 1"),
    (dict(kv_heads=4), "not divisible"),
])
def test_flash_rejects_bad_arguments(bad, match):
    kv_heads = bad.pop("kv_heads", 2)
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 6, kv_heads, 16, 32))
    with pytest.raises(ValueError, match=match):
        flash.flash_attention(q, k, v, **bad)


def test_importing_the_kernel_modules_builds_nothing():
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('import ran a subprocess')\n"
        "subprocess.Popen = refuse\n"
        "from kube_sqs_autoscaler_tpu_torch.workloads import flash, kernels\n"
        "assert kernels._loaded == {} and flash._bound == {}\n"
        "assert 'flash_fwd' in kernels.sources()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
