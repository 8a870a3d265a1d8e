"""The port's differentiable flash attention held against the JAX package's.

On the CPU the port's autograd wiring runs the plain versions of its
kernels (the lse forward, dq and dk/dv recomputed from the lse); the CUDA
kernels run only on the card and are held against those plain versions by
``chip_smoke.py``.  The reference runs its real Pallas kernels in interpret
mode, as ``tests/test_flash.py`` does, and differentiates them with
``jax.grad`` through its ``custom_vjp``.  Inputs come from numpy seeds.

Tolerances: f32 atol 2e-5 on outputs, lse and gradients (the same fp32
arithmetic summed in another order; gradients here are O(1), so 2e-5 is
about 20 fp32 ulps of the largest sums); bf16 atol 3e-2 (bf16 results, one
rounding step is ~8e-3 at magnitude 2, and the two sides round their
operands at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import flash as jax_flash
from kube_sqs_autoscaler_tpu_torch.workloads import flash

# tiny tests; the suite runs in several pytest workers that share the CPU
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def to_jax(arrs, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def to_torch(arrs, dtype, grad=False):
    return [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(grad)
            for a in arrs]


def close(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


# (batch, heads, q_len, k_len, head_dim, causal, q_shift)
LSE_CASES = {
    "causal": (1, 2, 64, 64, 32, True, 0),
    "full": (1, 2, 64, 64, 32, False, 0),
    "rectangular-shift": (1, 2, 32, 64, 32, True, 32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(LSE_CASES))
def test_lse_forward_matches_reference_kernel(case, dtype):
    b, h, sq, sk, d, causal, shift = LSE_CASES[case]
    host = arrays([(b, h, sq, d), (b, h, sk, d), (b, h, sk, d)], seed=1)
    want_out, want_lse = jax_flash.flash_attention_lse(
        *to_jax(host, dtype), causal=causal, q_shift=shift, interpret=True)
    out, lse = flash.flash_attention_lse(*to_torch(host, dtype),
                                         causal=causal, q_shift=shift)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, h, sq, d)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    close(out, want_out, dtype)
    # the lse is fp32 on both sides; in bf16 it inherits the inputs'
    # rounding only, so it holds the f32 tolerance's order of magnitude
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=1e-4, rtol=0)
    ref_out, ref_lse = flash.flash_attention_lse_reference(
        *to_torch(host, dtype), causal=causal, q_shift=shift)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)


# (batch, heads, kv_heads, seq, head_dim, causal, window)
GRAD_CASES = {
    "mha": (2, 2, 2, 64, 32, True, None),
    "gqa-h4-kv2": (1, 4, 2, 64, 32, True, None),
    "non-causal": (1, 2, 2, 64, 32, False, None),
    "window16": (1, 2, 2, 64, 32, True, 16),
    "ragged-s48": (1, 2, 2, 48, 32, True, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grads_match_jax_grad_of_reference_kernel(case, dtype):
    b, h, hkv, s, d, causal, window = GRAD_CASES[case]
    host = arrays([(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                   (b, h, s, d)], seed=2)
    weight = host.pop()

    def jax_loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal, window=window,
                                        interpret=True)
        return jnp.sum(out.astype(jnp.float32) * weight)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*to_jax(host, dtype))
    q, k, v = to_torch(host, dtype, grad=True)
    out = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None
    (out.float() * torch.from_numpy(weight)).sum().backward()
    for got, exp in zip((q.grad, k.grad, v.grad), want):
        assert tuple(got.shape) == exp.shape  # dk/dv compact under GQA
        close(got, exp, dtype)


def test_lse_cotangent_through_merge_matches_reference():
    # the second half of a causal problem's rows against its two key halves:
    # a q_shift hop over the first half and a diagonal hop over the second,
    # merged; the loss reads both the merged output and the merged lse
    b, h, s, d = 1, 2, 64, 32
    half = s // 2
    q, k, v, w_out, w_lse = arrays(
        [(b, h, half, d), (b, h, s, d), (b, h, s, d), (b, h, half, d),
         (b, h, half)], seed=3)

    def merged(lib, attend, q, k, v, zeros):
        acc_out, acc_lse = zeros
        for lo, shift in ((0, half), (half, 0)):
            out, lse = attend(q, k[:, :, lo:lo + half], v[:, :, lo:lo + half],
                              causal=True, q_shift=shift)
            acc_out, acc_lse = lib.merge_attention_partials(acc_out, acc_lse,
                                                            out, lse)
        return acc_out, acc_lse

    def jax_loss(q, k, v):
        zeros = (jnp.zeros((b, h, half, d), jnp.float32),
                 jnp.full((b, h, half), jax_flash.MERGE_NEG_INF, jnp.float32))
        attend = lambda *a, **kw: jax_flash.flash_attention_lse(  # noqa: E731
            *a, interpret=True, **kw)
        out, lse = merged(jax_flash, attend, q, k, v, zeros)
        return jnp.sum(out * w_out) + jnp.sum(lse * w_lse)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*to_jax([q, k, v],
                                                         "float32"))
    tq, tk, tv = to_torch([q, k, v], "float32", grad=True)
    zeros = (torch.zeros((b, h, half, d)),
             torch.full((b, h, half), flash.MERGE_NEG_INF))
    out, lse = merged(flash, flash.flash_attention_lse, tq, tk, tv, zeros)
    loss = (out * torch.from_numpy(w_out)).sum() + (
        lse * torch.from_numpy(w_lse)).sum()
    loss.backward()
    for got, exp in zip((tq.grad, tk.grad, tv.grad), want):
        close(got, exp, "float32")


def test_backward_halves_match_autograd_of_the_plain_forward():
    # dq and dk/dv recomputed from the lse equal autograd through the
    # plain forward, with an lse cotangent folded into Delta
    host = arrays([(1, 4, 40, 32), (1, 2, 40, 32), (1, 2, 40, 32),
                   (1, 4, 40, 32), (1, 4, 40)], seed=4)
    q, k, v = to_torch(host[:3], "float32", grad=True)
    dout, dlse = (torch.from_numpy(a) for a in host[3:])
    out, lse = flash.flash_fwd_reference(q, k, v, q_shift=3)
    torch.autograd.backward((out, lse), (dout, dlse))
    delta = flash.attention_delta(out.detach(), dout, dlse)
    args = (q.detach(), k.detach(), v.detach(), dout, lse.detach(), delta)
    dq = flash.flash_bwd_dq(*args, causal=True, q_shift=3)
    dk, dv = flash.flash_bwd_dkv(*args, causal=True, q_shift=3)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_no_grad_runs_the_plain_forward_and_cpu_never_counts_launches():
    counts = ("kernel_launches", "lse_launches", "dq_launches", "dkv_launches")
    before = [getattr(flash, name) for name in counts]
    q, k, v = to_torch(arrays([(1, 2, 16, 64)] * 3, seed=5), "float32",
                       grad=True)
    with torch.no_grad():
        assert flash.flash_attention(q, k, v).grad_fn is None
    flash.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None
    assert [getattr(flash, name) for name in counts] == before


def test_backward_wrappers_never_run_the_plain_version_off_the_cpu():
    q = torch.empty((1, 2, 16, 64), device="meta")
    stat = torch.empty((1, 2, 16), device="meta")
    for fn in (flash.flash_bwd_dq, flash.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, stat, stat)


def _train_head_views():
    # q, k, v as the model hands them over: head views of the fused
    # [B, S, 3 * H * D] projection at the train shape's widths (row stride
    # 3072), cut to a short sequence
    b, s, h, d = 2, 8, 16, 64
    fused = torch.zeros((b, s, 3 * h * d), dtype=torch.bfloat16)
    return [t.reshape(b, s, h, d).transpose(1, 2) for t in fused.chunk(3, -1)]


ALIGNMENT_CASES = {
    "fused-q": (lambda: _train_head_views()[0], None),
    "fused-k": (lambda: _train_head_views()[1], None),
    "fused-v": (lambda: _train_head_views()[2], None),
    "contiguous": (lambda: torch.zeros((2, 4, 16, 64), dtype=torch.bfloat16),
                   None),
    "odd-offset": (
        lambda: torch.zeros(2 * 4 * 16 * 64 + 1,
                            dtype=torch.bfloat16)[1:].view(2, 4, 16, 64),
        "first element"),
    "row-stride-65": (
        lambda: torch.zeros((2, 4, 16, 65), dtype=torch.bfloat16)[..., :64],
        "stride 65"),
}


@pytest.mark.parametrize("case", list(ALIGNMENT_CASES))
def test_bf16_row_alignment_check(case):
    make, rejected = ALIGNMENT_CASES[case]
    t = make()

    def check():
        flash.check_row_alignment("q", t.element_size(), t.storage_offset(),
                                  t.stride()[:3])

    # the same contract through the helper every bf16 launch calls, forward
    # and backward: the bad tensor is refused under its own name
    aligned = torch.zeros((2, 4, 16, 64), dtype=torch.bfloat16)

    def check_named():
        flash.check_rows_aligned(q=aligned, k=t, v=aligned)

    if rejected is None:
        check()
        check_named()
    else:
        with pytest.raises(ValueError, match=rejected):
            check()
        with pytest.raises(ValueError, match=f"^k rows .*{rejected}"):
            check_named()


def test_lse_rejects_a_negative_causal_shift():
    q, k, v = to_torch(arrays([(1, 2, 16, 32)] * 3, seed=6), "float32")
    with pytest.raises(ValueError, match="q_shift"):
        flash.flash_attention_lse(q, k, v, q_shift=-1)
    flash.flash_attention_lse(q, k, v, causal=False, q_shift=-1)
