"""The port's ring attention (``workloads/ring.py``) held against the JAX
package's on its virtual 8-device CPU mesh.

The port runs as 2, 4 or 8 gloo ranks in spawned processes
(``torch_mesh_ranks.py``), one spawn per rank count holding every case
of that count, each rank computing its shard's output and its q, k, v
gradients against a fixed cotangent.  The reference runs
``make_ring_attention`` (its einsum body) under ``jax.vjp`` on the same
numpy inputs over a mesh of the same ``(data, seq, model)`` shape.  The
port's one body, a flash call a hop, runs each kernel's plain version on
CPU tensors.

Tolerances: f32 outputs and gradients within 1e-5 (the same fp32
arithmetic summed in another order); bf16 outputs within 2e-2 (the
probabilities round to bf16 before the PV product in both, at a few
elements to the neighbouring value).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import flash as jax_flash
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import ring as jax_ring
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import distributed, flash, ring
from kube_sqs_autoscaler_tpu_torch.workloads import train
from kube_sqs_autoscaler_tpu_torch.workloads.model import _dense_attention
from .torch_mesh_ranks import AttentionSpawns, run_ranks

torch.set_num_threads(1)

F32, BF16 = 1e-5, 2e-2


def qkv(batch, heads, kv_heads, seq, dim, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, seq, dim)).astype(np.float32)
    k = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    v = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    cot = rng.standard_normal((batch, heads, seq, dim)).astype(np.float32)
    return q, k, v, cot


def case(kind="ring", tp=1, sp=4, window=None, shape=(4, 4, 4, 32, 8),
         seed=0, bf16=False):
    q, k, v, cot = qkv(*shape, seed)
    dtype = torch.bfloat16 if bf16 else torch.float32
    return dict(kind=kind, tp=tp, sp=sp, window=window, bf16=bf16,
                **{n: torch.from_numpy(a).to(dtype)
                   for n, a in zip(("q", "k", "v", "cot"), (q, k, v, cot))})


# every case by id: (world, case); one spawn per world holds its cases
CASES = {
    "sp2": (2, case(sp=2)),
    "sp2-gqa": (2, case(sp=2, shape=(2, 4, 2, 32, 8), seed=7)),
    "sp4": (4, case()),
    "sp4-window5": (4, case(window=5)),
    "sp4-window16": (4, case(window=16)),
    "sp4-window31": (4, case(window=31)),
    "tp2-sp2-gqa-window7": (4, case(tp=2, sp=2, window=7,
                                    shape=(4, 4, 2, 16, 8), seed=5)),
    "tp2-sp2": (4, case(tp=2, sp=2, shape=(4, 4, 4, 16, 8), seed=3)),
    "tp2-sp2-gqa": (4, case(tp=2, sp=2, shape=(4, 8, 2, 32, 8), seed=4)),
    "sp4-bf16": (4, case(bf16=True, seed=6)),
    "sp4-gqa": (4, case(shape=(2, 4, 2, 32, 8), seed=7)),
    "sp8": (8, case(sp=8)),
    "dp2-sp2-tp2": (8, case(tp=2, sp=2, shape=(4, 4, 4, 16, 8), seed=3)),
}

SPAWNS = AttentionSpawns(CASES)


def port(name):
    """The port's global output and gradients of case ``name``."""
    return SPAWNS.result(name)


def reference(name):
    """The JAX package's ring attention and its vjp on the same inputs,
    over a mesh of the same shape on the virtual CPU devices."""
    world, c = CASES[name]
    mesh = jax_train.make_mesh(jax.devices()[:world], model_parallel=c["tp"],
                               seq_parallel=c["sp"])
    dtype = jnp.bfloat16 if c["bf16"] else jnp.float32
    q, k, v, cot = (jnp.asarray(c[n].float().numpy(), dtype)
                    for n in ("q", "k", "v", "cot"))
    fn = jax_ring.make_ring_attention(mesh, window=c["window"])

    @jax.jit
    def forward_and_vjp(q, k, v, cot):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(cot))

    out, dq, dk, dv = forward_and_vjp(q, k, v, cot)
    return {key: np.asarray(val, np.float32) for key, val in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


def assert_matches(name, grads=True):
    got, want = port(name), reference(name)
    tol = BF16 if CASES[name][1]["bf16"] else F32
    for key in ("out", "dq", "dk", "dv") if grads else ("out",):
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                   err_msg=f"{name}: {key}")


@pytest.mark.parametrize("name", ["sp2", "sp4", "sp8"])
def test_ring_matches_reference_causal(name):
    assert_matches(name)


@pytest.mark.parametrize("window", [5, 16, 31])
def test_windowed_ring_matches_reference(window):
    # an earlier rank's hop is one call over the rows the band reaches,
    # q_shift = (d - e) * S_local; a hop wholly outside it is skipped
    assert_matches(f"sp4-window{window}")


def test_windowed_ring_gqa_and_grads_match_reference():
    assert_matches("tp2-sp2-gqa-window7")


@pytest.mark.parametrize("name", ["tp2-sp2", "dp2-sp2-tp2"])
def test_ring_matches_reference_with_tp_and_dp(name):
    assert_matches(name)


def test_ring_is_causal_against_the_ports_dense_attention():
    # an oracle independent of the reference: dense causal attention of
    # the whole sequence
    c = CASES["sp4"][1]
    got = port("sp4")["out"]
    want = _dense_attention(c["q"], c["k"], c["v"]).numpy()
    np.testing.assert_allclose(got, want, atol=F32, rtol=0)


@pytest.mark.parametrize("name", ["tp2-sp2-gqa", "sp2-gqa", "sp4-gqa"])
def test_ring_gqa_matches_reference(name):
    # compact k/v rotate as they are; the per-hop dq and dk/dv plain
    # versions run with each hop's lse and the merge's lse cotangent
    assert_matches(name)


def test_ring_matches_reference_bf16():
    assert_matches("sp4-bf16", grads=False)


def test_trivial_seq_axis_uses_the_per_rank_attention():
    # seq = 1: the per-rank dispatcher (flash.make_sharded_attention),
    # GQA-native, dense on CPU tensors
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    attend = train.mesh_attention_fn(mesh)
    assert getattr(attend, "gqa_native", False)
    assert not hasattr(attend, "_zigzag")
    q, k, v, _ = (torch.from_numpy(a) for a in qkv(2, 4, 2, 16, 8, 1))
    want = _dense_attention(q, flash.repeat_kv(k, 2), flash.repeat_kv(v, 2))
    np.testing.assert_allclose(attend(q, k, v).numpy(), want.numpy(),
                               atol=F32, rtol=0)
    assert train.mesh_attention_fn(mesh, window=4)(q, k, v).shape == q.shape


def test_merge_rows_and_repeat_kv_match_reference():
    # merge_rows merges a partial over rows [lo, hi) as the reference's
    # merge_attention_partials does, and leaves the other rows alone; the
    # compact k/v broadcast is the reference's expand_kv
    rng = np.random.default_rng(3)
    acc = rng.standard_normal((2, 2, 6, 8)).astype(np.float32)
    acc_lse = rng.standard_normal((2, 2, 6)).astype(np.float32)
    out = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    lse = rng.standard_normal((2, 2, 4)).astype(np.float32)
    got = ring.merge_rows(*(torch.from_numpy(a)
                            for a in (acc, acc_lse, out, lse)), 2, 6)
    want = jax_flash.merge_attention_partials(
        *(jnp.asarray(a) for a in (acc[:, :, 2:], acc_lse[:, :, 2:], out,
                                   lse)))
    np.testing.assert_array_equal(got[0][:, :, :2].numpy(), acc[:, :, :2])
    np.testing.assert_array_equal(got[1][:, :, :2].numpy(), acc_lse[:, :, :2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, :, 2:].numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0)
    t = rng.standard_normal((2, 2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        flash.repeat_kv(torch.from_numpy(t), 3).numpy(),
        np.asarray(jax_ring.expand_kv(jnp.asarray(t), 3)))


def test_seq_parallel_loss_matches_the_reference_loss():
    # the model over the ring: the shares of every rank sum to the
    # reference's mean next-token loss of the whole batch
    jcfg = jax_model.ModelConfig(vocab_size=64, d_model=32, n_heads=4,
                                 n_layers=2, d_ff=64, max_seq_len=32,
                                 dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jax_model.init_params(jax.random.key(2), jcfg))
    tokens = np.random.default_rng(4).integers(0, 64, (4, 32)).astype(
        np.int32)
    want = float(jax.jit(partial(jax_train.loss_fn, config=jcfg))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens)))
    from kube_sqs_autoscaler_tpu_torch.workloads.convert import (
        params_from_jax,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.model import ModelConfig

    cfg = ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                      d_ff=64, max_seq_len=32, dtype=torch.float32)
    results = run_ranks("train", 4, {"runs": [dict(
        tp=2, sp=2, config=cfg, train=dict(learning_rate=0.0),
        params=params_from_jax(params, cfg, "cpu"), family="gpt",
        batches=[torch.from_numpy(tokens)])]}, timeout=240)
    assert results[0][0]["losses"][0] == pytest.approx(want, rel=1e-5)
