"""Chip smoke test of the PyTorch port on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure makes the run exit non-zero and print no result):

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: every CUDA source under ``kube_sqs_autoscaler_tpu_torch/csrc``
   (one ``nvcc`` each, in parallel) into ``build/kernels/``; then both
   libraries' SASS (``cuobjdump -sass``): the bf16 forward, dq and dk/dv
   kernels must run on the tensor cores (``HMMA``/``HGMMA``) and the f32
   ones must not; and every kernel's registers, local memory (spills) and
   shared memory (``cudaFuncGetAttributes``), where the bf16 D=64 kernels
   must use no local memory;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes and at the ragged, GQA, windowed, non-causal and
   shifted rectangular shapes, and timed beside its plain version, the
   equivalent PyTorch library call and the least time the card could take
   (its bound): the serving forward (``flash_fwd``, also at the
   continuous engine's refill sizes 1 and 3, at the sharded plane's
   refill of 32 rows and its resume inserts of 1 and 8 rows of 544 tokens,
   at the llama family's GQA shapes (8 query heads over 2 kv heads, D =
   64: a batch or refill of 8 rows of 512, classify's 1024, a refill of
   one, and a window of 128 at 1024, against SDPA with ``enable_gqa``),
   and at the train shape, where the eval passes run it), and the
   training forward with
   the lse (``flash_fwd_lse``) and its two backward halves
   (``flash_bwd_dq``, ``flash_bwd_dkv``), the backward also fed from the
   forward kernel's own output and lse; a misaligned bf16 input must be
   refused with ``ValueError``;
4. serving path: the worker binary's code path in-process, at the
   built-in GPT's full width in bf16, in generate and classify mode; every
   message must be answered once and deleted, and every kernel of the path
   must have launched (the launch counts are zeroed just before each mode
   and read just after); plus an f32 prefill whose logits must match the
   dense-attention path;
5. continuous: the binary's ``--demo 64`` of the generate cell through the
   batch worker and ``--continuous`` at decode blocks 1 and 8, whose bf16
   replies must be identical, with ``4 x inserts`` forward launches and no
   lse launch; the block-8 worker driven cycle by cycle (at most one
   decode dispatch a cycle, and at most one host transfer for the block
   plus one for each insert settled that cycle; the share of settles that
   found the next block still running); and the batcher in f32 at full
   width over 24 ragged prompts submitted a few at a time at blocks 1 and
   8, each request against ``generate`` for its prompt alone up to the
   first near-tie;
6. throughput and profile: warm ``--demo 64`` rates in each mode (the
   continuous engine's with its mean time to first token), and
   ``torch.profiler`` (device activity) over one batch in each mode and
   over a 16-message continuous drain at blocks 1 and 8 (device busy share
   and the kernels that take the time);
7. sqs: a local SQS endpoint (the JSON protocol over the port's in-memory
   queue, on 127.0.0.1) loaded with the ``--demo 64`` bodies; the worker
   binary started as a child process with ``--sqs-queue-url
   --result-queue-url --metrics-port``, continuous at decode block 8 and
   then the batch worker: all 64 answered once and deleted, every call
   signed, the reply bytes equal to the in-memory demo run's, ``/metrics``
   scraped mid-run; and a ``QueueWorker`` with ``profile_dir`` whose trace
   must name ``flash_fwd``;
8. fleet: the deterministic ``WorkerPool`` episode (``FakeClock``,
   ``--demo 64`` traffic, min 1, max 3, a busy replica killed and another
   hung) in bf16 (spawns, re-dispatch, the hang watchdog, the drain back
   to min, every request answered once, the params shared, ``4 x
   inserts`` forward launches; peak memory beside one replica's) and in
   f32 (each reply against ``generate`` alone up to the first near-tie);
   the binary's ``--fleet-max-replicas 3`` on the real clock (rates, mean
   TTFT, replica trajectory, busy share); ``python -m
   kube_sqs_autoscaler_tpu_torch.fleet`` must exit 0;
9. shards: the sharded serving plane at the generate cell's width, 8
   slots a shard: a one-shard plane (``sharded=True``) whose 64 bf16
   replies must equal the block-8 worker's byte for byte; the binary's
   ``--demo 64 --continuous --decode-block 8 --shards 4`` (every message
   answered once, ``4 x inserts`` forward launches, no lse, one gang
   dispatch a settled block) and the same plane driven cycle by cycle
   (exactly one gang dispatch a busy cycle, at most one host transfer a
   cycle; its peak memory); a 4-shard f32 plane over the staggered
   requests against ``generate`` up to the first near-tie; a
   ``FakeClock`` chaos episode of ``ShardedWorkerPool.serving(min=1,
   max=4)`` under the control loop, in bf16 and f32, with a poisoned, a
   wedged and a mask-corrupted shard (exactly once, one quarantine of each
   cause, rows evacuated through a resume insert at [M, 8, 544, 64],
   every quarantined shard probed and readmitted, f32 replies against
   ``generate``); warm rates of one block-8 worker, the plane and the
   3-replica fleet one after another, and a profiled plane drain;
10. llama: the binary's built-in llama (``--family llama``, 2 kv heads) in
   bf16 through the batch worker and ``--continuous`` at decode blocks 1
   and 8 (replies identical, ``4 x`` prompt passes forward launches, no
   lse), the block-8 worker cycle by cycle (at most one decode dispatch a
   cycle) with its 8.500 MiB cache, a one-shard plane (replies equal to
   the block-8 worker's), ``--shards 4`` and ``--fleet-max-replicas 3``
   (replies counted against the single worker's); in f32 the staggered
   prompts through the batcher at blocks 1 and 8 against
   ``llama_generate`` up to the first near-tie, and a model with a window
   of 128: the kernel's windowed GQA prefill within 1e-4 of dense, the
   rolling-cache generate equal to the full cache's; warm rates of the GPT
   and the llama one after another (batch, block 8, ``--shards 4``);
11. int8: the built-in GPT and llama in bf16 with ``--quantize int8``,
   ``--quantize-kv`` and both: codes quantized on the card byte-equal to
   the CPU's, the weight bytes from the binary's log line, the 8-slot int8
   caches (18.0625 MiB GPT, 4.5156 MiB llama); replies identical across
   the batch worker, blocks 1 and 8 and S = 1 with ``n_layers x`` prompt
   passes forward launches; in f32 (int8 weights and cache) the
   staggered prompts through blocks 1 and 8 and a 4-shard plane against
   the port's own int8 generate up to the first near-tie; warm rates and
   peak memory of bf16, int8 weights, int8 cache and both at block 8 and
   ``--shards 4``; a profiled int8 plane;
12. prefix: ``--prefix-ids`` of 37 tokens at both families' full width,
   full-precision and int8 cache, through batch, blocks 1 and 8 and
   ``--shards 4`` (the prefix's ``n_layers`` launches once, the suffix
   inserts none; replies counted against the batch worker's); in f32 the
   staggered suffixes through the block-8 batcher behind the prefix
   against ``generate`` of prefix and suffix joined (the int8 layout
   against its own prefix generate), up to the first near-tie;
13. speculative: ``--speculative-draft-layers 2 --speculative-draft-tokens
   4`` for both families in bf16 through the batch worker
   (``n_layers + draft_layers`` forward launches a batch: the target's
   and the draft's prefill) and ``--continuous`` (``n_layers`` an
   insert: one target prefill seeds both caches), replies counted
   against the plain greedy worker's on the same weights, the accepted
   fraction, rounds a request and second rounds dispatched ahead;
   ``--temperature 0.8`` answering 64 of 64 in the vocabulary; the
   acceptance rule on the card over 10^5 rows of synthetic distributions
   (V = 32), its emitted marginal within total variation 0.01 of the
   warped target; in f32 the staggered prompts through the batch
   ``speculative_generate`` and the slot engine against greedy
   ``generate`` up to the first near-tie; the GPT with ``--quantize-kv``
   and behind the 37-token prefix;
14. beam: ``--beams 4``, and with ``--length-penalty 0.6 --eos-id`` a
   token the demo emits, for both families through the batch worker and
   ``--continuous`` (``n_layers`` launches a prompt pass), replies counted
   between the two; in f32 the beam slots against ``beam_search`` of each
   prompt alone up to the first near-tie in the search's selection; the
   GPT with ``--quantize-kv`` and the prefix; warm rates of plain block-1
   ``--continuous``, speculative and beams; ``torch.profiler`` over a
   beam drain with the parent gather's share;
15. odd head dim: the trainer at ``--d-model 64 --n-heads 4`` (D = 16)
   through dense attention with no kernel launch, its loss falling; the
   forward wrapper called directly at D = 16 must raise ``ValueError``;
16. training: an f32 loss and gradient at the flagship train width through
   the kernels against the dense-attention path; the trainer binary's code
   path in-process at the flagship config (GPT, d_model 1024, 16 heads,
   8 layers, d_ff 4096, vocab 8192, B=8, S=2048) in bf16 for 10
   ``--overfit`` steps, whose losses must be finite and fall and whose
   lse-forward, dq and dk/dv launch counts must each be ``n_layers x
   steps`` (and twice that for the forward under ``--remat``); its steady
   step time, tokens/s, MFU and peak memory; ``torch.profiler`` over one
   step;
17. a JSON line ``{"kernels": [...]}`` with each kernel's numbers;
18. the last line, ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and exits non-zero without a
card or outside a checkout of the repository.

``python3 chip_smoke.py --repair-cost PARENT`` measures instead what a
change to the model's numerics costs: for the checkout at ``PARENT`` and
this one, in the order parent, this, this, parent, each in a process of
its own, the operators a decode step of 8 rows dispatches, the GPT decode
step's time, and the flagship trainer's steady step time and peak
memory.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from functools import partial
from pathlib import Path

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
TOL_REASON = {
    "bfloat16": "bf16 output: one rounding step is ~4e-3 at magnitude 1, "
                "and the kernel rounds its probabilities at each tile's "
                "running max where the plain version uses the row max",
    "float32": "the same fp32 arithmetic summed in another order",
}
# the training kernels' outputs (gradients summed over up to 2048 keys or
# 4 x 2048 rows) reach magnitudes of several units, where one bf16 step is
# 2^-8 of the magnitude: their error is held to TOL times max(1, max|want|)
TRAIN_TOL_REASON = {
    "bfloat16": "bf16 results: one rounding step is 2^-8 of the magnitude, "
                "and p and ds round to bf16 before their products on both "
                "sides, from fp32 values summed in another order",
    "float32": "the same fp32 arithmetic summed in another order over up to "
               "8192 terms",
}
TRAIN_SHAPE = (8, 16, 2048, 64)  # (B, H, S, D) of the flagship train config
TRAIN_ARGS = ["--d-model", "1024", "--n-heads", "16", "--n-layers", "8",
              "--d-ff", "4096", "--vocab-size", "8192", "--seq-len", "2048",
              "--batch-size", "8", "--device", "cuda"]
TRAIN_LAYERS = 8
TRAIN_STEPS = 10
EVAL_EVERY = 5
MAIN_SHAPES = [(8, 8, 512, 64), (8, 8, 1024, 64)]  # generate, classify
# the sharded plane's prompt passes: a refill of 4 shards x 8 slots, and
# resume inserts of 1 and 8 evacuated rows (512 prompt + 32 produced)
PLANE_SHAPES = [(32, 8, 512, 64), (1, 8, 544, 64), (8, 8, 544, 64)]
# the shared prefix's one prompt pass: 37 tokens, no multiple of the tiles
PREFIX_SHAPES = [(1, 8, 37, 64)]
GENERATE_ARGS = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
                 "--generate-tokens", "32", "--result-queue-url",
                 "demo://replies"]
CLASSIFY_ARGS = ["--demo", "16", "--batch-size", "8", "--seq-len", "1024",
                 "--result-queue-url", "demo://replies"]
# the generate cell's traffic through the batch worker, then through the
# continuous engine's rolling slots at decode blocks 1 and 8
SERVE_MODES = (("generate", GENERATE_ARGS),
               ("continuous-b1", [*GENERATE_ARGS, "--continuous",
                                  "--decode-block", "1"]),
               ("continuous-b8", [*GENERATE_ARGS, "--continuous",
                                  "--decode-block", "8"]))
MARGIN = 1e-4  # greedy tokens are compared up to the first near-tie
# the llama family (--family llama: the built-in llama, 8 query heads over
# 2 kv heads, D = 64): its prompt passes as (B, H, H_kv, S, D) and window
LLAMA_SHAPES = {
    "gqa-h8-kv2-d64": ((8, 8, 2, 512, 64), None),
    "gqa-classify-s1024": ((8, 8, 2, 1024, 64), None),
    "gqa-refill-1": ((1, 8, 2, 512, 64), None),
    "gqa-window128-s1024": ((2, 8, 2, 1024, 64), 128),
    "gqa-prefix-37": ((1, 8, 2, 37, 64), None),
}
LLAMA_ARGS = [*GENERATE_ARGS, "--family", "llama"]
LLAMA_LAYERS = 4
# 8 slots x 4 layers x (k, v) x 2 kv heads x 544 positions x 64 x 2 bytes
LLAMA_CACHE_MIB = 8.5


class Smoke:
    def __init__(self) -> None:
        self.failures: list[str] = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok    " if ok else "FAIL  ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name: str, fn, *args):
        """Run one phase; an exception fails the run (after the other
        phases have run) and is printed, never swallowed."""
        print(f"== {name}", flush=True)
        start = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            self.failures.append(f"phase {name} raised")
            return None
        finally:
            print(f"-- {name}: {time.perf_counter() - start:.3f} s",
                  flush=True)


def device_phase(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    print(f"torch {info['torch']} cuda {info['cuda']} "
          f"devices {info['count']}", flush=True)
    return info


def build_phase(kernels) -> dict:
    start = time.perf_counter()
    paths = kernels.build_all()
    seconds = time.perf_counter() - start
    for name, path in paths.items():
        print(f"built {name} -> {path}", flush=True)
    print(f"build_s {seconds:.3f}", flush=True)
    return {"build_s": seconds, "paths": paths}


SASS_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SOURCES = ("flash_fwd", "flash_bwd")


def sass_instantiation(function: str) -> tuple[str, str, int] | None:
    """``(kernel, dtype, head dim)`` of a flash kernel's mangled name
    (``flash_fwd_kernel<__nv_bfloat16, 64>``,
    ``flash_bwd_dq_kernel<float, 128>`` and the like), else ``None``."""
    found = re.search(
        r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(13__nv_bfloat16|f)Li(\d+)E",
        function)
    if not found:
        return None
    kernel, dtype, dim = found.groups()
    return (kernel.removesuffix("_kernel"),
            "bf16" if dtype.endswith("bfloat16") else "f32", int(dim))


def sass_counts(sass: str) -> dict[tuple[str, str, int], int]:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in each flash kernel
    instantiation of ``cuobjdump -sass`` output."""
    counts: dict[tuple[str, str, int], int] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = sass_instantiation(line.split("Function :", 1)[1])
            if current is not None:
                counts[current] = 0
        elif current is not None and re.search(r"\bH(G)?MMA\.", line):
            counts[current] += 1
    return counts


def sass_phase(kernels, build: dict, smoke: Smoke) -> dict:
    """Both libraries' machine code (``cuobjdump -sass``): the bf16
    kernels must use the tensor cores and the f32 ones must not."""
    counts: dict[tuple[str, str, int], int] = {}
    for source in SOURCES:
        counts.update(sass_counts(subprocess.run(
            [kernels.toolkit_binary("cuobjdump"), "-sass",
             str(build["paths"][source])],
            capture_output=True, text=True, timeout=300, check=True).stdout))
    for kernel in SASS_KERNELS:
        for dtype in ("bf16", "f32"):
            for dim in (64, 128):
                n = counts.get((kernel, dtype, dim))
                want = "> 0" if dtype == "bf16" else "0"
                smoke.check(
                    n is not None and (n > 0 if dtype == "bf16" else n == 0),
                    f"SASS {kernel} {dtype} D={dim}: {n} HMMA/HGMMA "
                    f"instructions, want {want} (bf16 on the tensor cores, "
                    f"f32 scalar)")
    return {f"{k} {d} {dim}": n for (k, d, dim), n in counts.items()}


def resources_phase(flash, smoke: Smoke) -> dict:
    """Registers, local memory and shared memory of every kernel; local
    memory in the bf16 D=64 kernels (the main paths') means spills and
    fails the run."""
    out = {}
    for source in SOURCES:
        for r in flash.kernel_resources(source):
            out[(r["kernel"], r["dtype"], r["head_dim"])] = r
            print(f"resources {r['kernel']} {r['dtype']} D={r['head_dim']}: "
                  f"{r['registers']} registers, {r['local_bytes']} bytes "
                  f"local (spills), {r['static_smem_bytes']} static + "
                  f"{r['dynamic_smem_bytes']} dynamic bytes shared",
                  flush=True)
    for kernel in SASS_KERNELS:
        r = out.get((kernel, "bf16", 64))
        smoke.check(r is not None and r["local_bytes"] == 0,
                    f"{kernel} bf16 D=64 uses no local memory (no spills): "
                    f"{None if r is None else r['local_bytes']} bytes")
    return out


def make_qkv(torch, batch, heads, kv_heads, seq, dim, dtype, strided, seed):
    """q, k, v on the card; ``strided`` takes them as the model does: the
    GPT's as head views of one fused [B, S, 3 * H * D] projection, the
    llama's (``kv_heads < heads``) with q and k contiguous (they leave
    RoPE as new tensors) and v a head view of the fused [B, S, 2 * H_kv *
    D] kv projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided and heads != kv_heads:
        q = torch.randn((batch, heads, seq, dim), generator=g, device="cuda")
        k = torch.randn((batch, kv_heads, seq, dim), generator=g,
                        device="cuda")
        kv = torch.randn((batch, seq, 2 * kv_heads * dim), generator=g,
                         device="cuda").to(dtype)
        v = kv[..., kv_heads * dim:].reshape(batch, seq, kv_heads, dim)
        return q.to(dtype), k.to(dtype), v.transpose(1, 2)
    if strided:
        fused = torch.randn((batch, seq, 3 * heads * dim), generator=g,
                            device="cuda").to(dtype)
        q, k, v = fused.chunk(3, dim=-1)
        return tuple(t.reshape(batch, seq, heads, dim).transpose(1, 2)
                     for t in (q, k, v))
    q = torch.randn((batch, heads, seq, dim), generator=g, device="cuda")
    k = torch.randn((batch, kv_heads, seq, dim), generator=g, device="cuda")
    v = torch.randn((batch, kv_heads, seq, dim), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# per kernel: (q-shaped tensors moved, k-shaped tensors moved, fp32 row
# vectors moved, products of D multiply-adds per live (row, key) pair)
BOUND_TERMS = {
    "fwd": (2, 2, 0, 2),      # q, out; k, v; QK^T and PV
    "fwd_lse": (2, 2, 1, 2),  # and the lse
    "dq": (3, 2, 2, 3),       # q, dout, dq; k, v; lse, delta; S, dP, dS K
    "dkv": (2, 4, 2, 4),      # q, dout; k, v, dk, dv; lse, delta; S, dP,
                              # P^T dO, dS^T Q
}


def flash_ops(shape, causal=True, window=None, kind="fwd") -> int:
    """The kernel's products in FLOPs: 2 per multiply-add, counting only
    the live (row, key) pairs of this mask."""
    batch, heads, seq, dim = shape
    if not causal:
        pairs = seq * seq
    elif window is None:
        pairs = seq * (seq + 1) // 2
    else:
        pairs = sum(min(r + 1, window) for r in range(seq))
    return 2 * BOUND_TERMS[kind][3] * batch * heads * dim * pairs


def flash_bound_ms(shape, kv_heads, dtype_name, causal=True, window=None,
                   kind="fwd"):
    """The least time the card could take for the kernel's work: each
    input read once and each output written once over the memory rate,
    or the products (:func:`flash_ops`) over the peak rate of the inputs'
    type, whichever is longer."""
    batch, heads, seq, dim = shape
    size = 2 if dtype_name == "bfloat16" else 4
    n_q, n_kv, n_rows, _ = BOUND_TERMS[kind]
    moved = (n_q * batch * heads * seq * dim * size
             + n_kv * batch * kv_heads * seq * dim * size
             + n_rows * batch * heads * seq * 4)
    ops = flash_ops(shape, causal, window, kind)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, flash, smoke: Smoke) -> dict:
    import torch.nn.functional as F

    cases = [
        # (label, batch, heads, kv_heads, seq, dim, window, strided)
        ("generate-prefill", 8, 8, 8, 512, 64, None, True),
        ("classify", 8, 8, 8, 1024, 64, None, True),
        ("refill-1", 1, 8, 8, 512, 64, None, True),
        ("refill-3", 3, 8, 8, 512, 64, None, True),
        # the sharded plane: a refill over 4 shards of 8, and the resume
        # insert of evacuated rows (prompt + produced, 512 + 32)
        ("plane-refill-32", 32, 8, 8, 512, 64, None, True),
        ("resume-1", 1, 8, 8, 544, 64, None, True),
        ("resume-8", 8, 8, 8, 544, 64, None, True),
        # the shared prefix's prompt pass (--prefix-ids of 37 tokens)
        ("prefix-37", 1, 8, 8, 37, 64, None, True),
        ("ragged-s48", 8, 8, 8, 48, 64, None, False),
        ("ragged-s7", 8, 8, 8, 7, 64, None, True),
        ("ragged-s1000", 8, 8, 8, 1000, 64, None, True),
        ("bucket-s16", 8, 8, 8, 16, 64, None, True),
        ("gqa-h8-kv2-d128", 2, 8, 2, 512, 128, None, False),
        ("window128-s1024", 2, 8, 8, 1024, 64, 128, False),
        # the llama family's prompt passes (H = 8 over H_kv = 2, D = 64,
        # its q/k/v layout): a batch or refill of 8, classify, a refill of
        # one, and a sliding window of 128 with GQA
        *((label, *shape, window, True)
          for label, (shape, window) in LLAMA_SHAPES.items()),
    ]
    results = []
    main_err = 0.0
    for seed, (label, b, h, hkv, s, d, window, strided) in enumerate(cases):
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            q, k, v = make_qkv(torch, b, h, hkv, s, d, dtype, strided, seed)
            got = flash.flash_attention(q, k, v, window=window)
            want = flash.flash_attention_reference(q, k, v, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            tol = TOL[dtype_name]
            smoke.check(
                finite and err <= tol,
                f"flash_fwd {label} {dtype_name} B={b} H={h} H_kv={hkv} "
                f"S={s} D={d} window={window}: max|d|={err:.3e} "
                f"tol={tol:g} ({TOL_REASON[dtype_name]})",
            )
            results.append({"case": label, "dtype": dtype_name,
                            "max_abs_err": err, "tol": tol})
            if dtype_name == "bfloat16" and label in ("generate-prefill",
                                                       "classify"):
                main_err = max(main_err, err)

    # the bf16 kernels' 16-byte copies need aligned rows: refused, not
    # copied, before any launch
    storage = torch.zeros(8 * 64 * 64 + 1, dtype=torch.bfloat16,
                          device="cuda")
    odd = storage[1:].view(1, 8, 64, 64)
    before = flash.kernel_launches
    try:
        flash.flash_fwd(odd, odd, odd)
        refused = False
    except ValueError as exc:
        refused = "16-byte" in str(exc)
    smoke.check(refused and flash.kernel_launches == before,
                "flash_fwd refuses a bf16 input whose rows are not 16-byte "
                "aligned with ValueError, before any launch")

    timings = {}
    for shape in (*MAIN_SHAPES, *PLANE_SHAPES, *PREFIX_SHAPES):
        b, h, s, d = shape
        q, k, v = make_qkv(torch, b, h, h, s, d, torch.bfloat16, True, 99)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        kernel_ms = time_ms(torch, lambda: flash.flash_attention(q, k, v))
        plain_ms = time_ms(
            torch, lambda: flash.flash_attention_reference(q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True))
        bound_ms, bound_by = flash_bound_ms(shape, h, "bfloat16")
        tflops = flash_ops(shape) / kernel_ms / 1e9
        timings[shape] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by, tflops=tflops)
        print(f"time flash_fwd bf16 {shape}: kernel {kernel_ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
    llama_timings = {label: gqa_timing(torch, flash, F, shape, window)
                     for label, (shape, window) in LLAMA_SHAPES.items()}
    llama_err = max(r["max_abs_err"] for r in results
                    if r["case"] in LLAMA_SHAPES and r["dtype"] == "bfloat16")
    return {"cases": results, "main_err": main_err, "timings": timings,
            "llama_timings": llama_timings, "llama_err": llama_err}


def gqa_timing(torch, flash, F, shape, window) -> dict:
    """The forward kernel at a llama shape ``(B, H, H_kv, S, D)`` in bf16,
    timed beside its plain version and SDPA (``enable_gqa=True`` where the
    card's torch has it, else over k/v repeated to H heads; a windowed
    case passes its mask), with its bound."""
    b, h, hkv, s, d = shape
    q, k, v = make_qkv(torch, b, h, hkv, s, d, torch.bfloat16, True, 98)
    kernel_ms = time_ms(torch, lambda: flash.flash_attention(
        q, k, v, window=window))
    plain_ms = time_ms(torch, lambda: flash.flash_attention_reference(
        q, k, v, window=window))
    mask = None
    if window is not None:
        rows = torch.arange(s, device="cuda")[:, None]
        cols = torch.arange(s, device="cuda")[None, :]
        mask = (cols <= rows) & (cols > rows - window)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    causal = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
    try:
        F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True, **causal)
        call = "F.scaled_dot_product_attention(enable_gqa=True) forward"
        kc_, vc_, extra = kc, vc, dict(enable_gqa=True)
    except TypeError:
        call = "F.scaled_dot_product_attention forward over repeat_kv k/v"
        kc_, vc_ = (flash.repeat_kv(t, h // hkv).contiguous()
                    for t in (kc, vc))
        extra = {}
    if mask is not None:
        call += " with a window mask"
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc_, vc_, **causal, **extra))
    bound_ms, bound_by = flash_bound_ms((b, h, s, d), hkv, "bfloat16",
                                        window=window)
    tflops = flash_ops((b, h, s, d), window=window) / kernel_ms / 1e9
    print(f"time flash_fwd bf16 GQA {shape} window={window}: kernel "
          f"{kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} "
          f"ms, {call} {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_call=call, bound_ms=bound_ms, bound_by=bound_by,
                tflops=tflops, kv_heads=hkv, window=window)


def main_path_phase(torch, flash, smoke: Smoke) -> dict:
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as worker

    out = {}
    for mode, args in (("generate", GENERATE_ARGS),
                       ("classify", CLASSIFY_ARGS)):
        flash.kernel_launches = 0
        summary = worker([*args, "--device", "cuda"])
        launches = flash.kernel_launches
        torch.cuda.synchronize()
        demo = int(args[args.index("--demo") + 1])
        replies = summary["replies"]
        attrs = summary["queue_attributes"]
        smoke.check(summary["processed"] == demo,
                    f"{mode}: processed {summary['processed']} of {demo}")
        smoke.check(len(replies) == demo and summary["duplicate_replies"] == 0,
                    f"{mode}: {len(replies)} distinct replies, "
                    f"{summary['duplicate_replies']} duplicates")
        smoke.check(attrs["ApproximateNumberOfMessages"] == "0"
                    and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                    f"{mode}: every input deleted ({attrs})")
        smoke.check(launches > 0, f"{mode}: flash_fwd launches {launches}")
        if mode == "generate":
            want = int(args[args.index("--generate-tokens") + 1])
            good = all(len(r.get("tokens", ())) == want
                       and all(0 <= t < 8192 for t in r["tokens"])
                       for r in replies.values())
        else:
            good = all(0 <= r.get("next_token", -1) < 8192
                       for r in replies.values())
        smoke.check(good, f"{mode}: every reply well formed")
        print(f"{mode}: {summary['msgs_per_s']:.3f} msgs/s, "
              f"{summary['tokens_per_s']:.3f} generated tokens/s, "
              f"{summary['elapsed_s']:.3f} s for {demo} messages "
              f"(first batch included)", flush=True)
        out[mode] = {k: summary[k] for k in (
            "msgs_per_s", "tokens_per_s", "elapsed_s", "processed")}
        out[mode]["launches"] = launches
    return out


def throughput_phase(torch) -> dict:
    """Warm end-to-end rates on one host clock: the binary's ``--demo 64``
    in each mode, the continuous engine at decode blocks 1 and 8 included,
    after the main path has paid the one-time costs (library load, cuBLAS
    set-up).  The batch worker's first tokens reach the host with its
    whole batch, so its time to first token is its mean cycle."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as worker

    out = {}
    for mode, args in (*SERVE_MODES, ("classify", CLASSIFY_ARGS)):
        summary = worker([*demo64(args), "--device", "cuda"])
        cycle = summary["cycle"]
        out[mode] = {k: summary[k] for k in (
            "msgs_per_s", "tokens_per_s", "elapsed_s", "processed",
            "block_utilization")}
        out[mode]["cycle_p50_s"] = cycle["p50_s"]
        ttft = ""
        if mode != "classify":
            out[mode]["ttft_mean_s"] = summary["ttft_mean_s"] or \
                cycle["mean_s"]
            ttft = f", mean TTFT {out[mode]['ttft_mean_s'] * 1e3:.3f} ms"
        print(f"warm {mode} --demo 64: {summary['msgs_per_s']:.3f} msgs/s, "
              f"{summary['tokens_per_s']:.3f} generated tokens/s{ttft}, "
              f"cycle p50 {cycle['p50_s'] * 1e3:.3f} ms over "
              f"{cycle['count']} cycles, block utilization "
              f"{summary['block_utilization']}", flush=True)
    return out


def device_breakdown(prof):
    """``(kernels, copies)`` of a profile, each a list of ``(device ms,
    count, name)``, kernels sorted by time.  Device rows only: operator
    rows repeat their kernels' time.  Copies are listed apart: the trace
    may also hold copies made before the window."""
    kernels, copies = [], []
    for event in prof.key_averages():
        if not str(event.device_type).endswith("CUDA"):
            continue
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = event.self_cuda_time_total
        if device_us > 0:
            row = (device_us / 1e3, event.count, event.key)
            is_copy = event.key.startswith(("Memcpy", "Memset"))
            (copies if is_copy else kernels).append(row)
    kernels.sort(reverse=True)
    return kernels, copies


def profile_phase(torch) -> dict:
    """Where one warm batch's time goes: ``torch.profiler`` around the
    worker's serve loop (weights already on the card) for one batch of 8
    in each mode; the device busy share is the summed kernel and copy
    time over the loop's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.model import init_params
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    out = {}
    for mode, argv in (("generate", GENERATE_ARGS),
                       ("classify", CLASSIFY_ARGS)):
        args = binary.build_parser().parse_args(argv)
        config = binary.builtin_config(args.seq_len, args.generate_tokens)
        params = init_params(config, torch.Generator().manual_seed(0),
                             "cuda")
        service_config = ServiceConfig(
            queue_url="", batch_size=8, seq_len=args.seq_len,
            generate_tokens=args.generate_tokens,
            result_queue_url=args.result_queue_url,
        )
        torch.cuda.synchronize()
        # device activity only, as the plane's and the fleet's profiles:
        # recording the host operators too adds seconds of post-processing
        # and nothing this phase reads
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            summary = binary.run_demo(8, params, config, service_config,
                                      torch.device("cuda"))
            torch.cuda.synchronize()
        wall_ms = summary["elapsed_s"] * 1e3
        kernels, copies = device_breakdown(prof)
        busy_ms = sum(ms for ms, _, _ in kernels)
        copy_ms = sum(ms for ms, _, _ in copies)
        flash_ms = sum(ms for ms, _, key in kernels if "flash_fwd" in key)
        print(f"profile {mode} (one batch of 8, profiler on): wall "
              f"{wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), flash_fwd {flash_ms:.3f} ms, "
              f"copies {copy_ms:.3f} ms "
              f"(x{sum(count for _, count, _ in copies)})", flush=True)
        for ms, count, key in kernels[:8]:
            print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
        out[mode] = {"wall_ms": wall_ms, "kernel_busy_ms": busy_ms,
                     "copy_ms": copy_ms, "flash_ms": flash_ms}
    return out


def demo64(args: list[str]) -> list[str]:
    args = list(args)
    args[args.index("--demo") + 1] = "64"
    return args


def continuous_phase(torch, flash, smoke: Smoke) -> dict:
    """The worker binary's ``--demo 64`` at the generate cell's shape in
    bf16 through the batch worker and the continuous engine at decode
    blocks 1 and 8: every refill admits 8 rows of 512 tokens and every
    decode runs over one [8, 8, 544, 64] cache, so the replies must be
    identical across the three; launch counts zeroed just before each run
    and read just after."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as worker

    out, replies = {}, {}
    demo = 64
    for mode, args in SERVE_MODES:
        zero_counts(flash)
        summary = worker([*demo64(args), "--device", "cuda"])
        launched = counts(flash)
        torch.cuda.synchronize()
        attrs = summary["queue_attributes"]
        replies[mode] = {rid: json.dumps(body) for rid, body in
                         summary["replies"].items()}
        smoke.check(summary["processed"] == demo
                    and len(replies[mode]) == demo
                    and summary["duplicate_replies"] == 0,
                    f"{mode}: processed {summary['processed']} of {demo}, "
                    f"{len(replies[mode])} distinct replies, "
                    f"{summary['duplicate_replies']} duplicates")
        smoke.check(attrs["ApproximateNumberOfMessages"] == "0"
                    and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                    f"{mode}: every input deleted ({attrs})")
        smoke.check(all(len(r.get("tokens", ())) == 32
                        and all(0 <= t < 8192 for t in r["tokens"])
                        for r in summary["replies"].values()),
                    f"{mode}: every reply holds 32 tokens in the vocabulary")
        inserts = summary["insert_dispatches"]
        if mode != "generate":
            smoke.check(
                inserts == demo // 8
                and launched["flash_fwd"] == 4 * inserts
                and launched["flash_fwd_lse"] == 0,
                f"{mode}: {inserts} inserts of 8 rows, flash_fwd launches "
                f"{launched['flash_fwd']} = 4 layers x inserts, lse "
                f"launches {launched['flash_fwd_lse']}")
        out[mode] = {"launches": launched["flash_fwd"],
                     "insert_dispatches": inserts,
                     "decode_dispatches": summary["decode_dispatches"],
                     "host_transfers": summary["host_transfers"],
                     "replies": replies[mode]}
        print(f"{mode}: launches {launched}, inserts {inserts}, decode "
              f"dispatches {summary['decode_dispatches']}, host transfers "
              f"{summary['host_transfers']}", flush=True)
    for mode in ("continuous-b1", "continuous-b8"):
        same = replies[mode] == replies["generate"]
        smoke.check(same, f"{mode}: the {len(replies[mode])} replies are "
                    "identical to the batch worker's (bf16, greedy)")
    return out


def demo_bodies(n: int = 64, vocab: int = 8192, seq_len: int = 512):
    """The binary's ``--demo n`` bodies (seed 0), as JSON strings."""
    rng = np.random.default_rng(0)
    return [json.dumps(rng.integers(0, vocab, seq_len).tolist())
            for _ in range(n)]


def demo_setup(torch, argv: list[str], decode_block: int = 1):
    """The worker binary's built-in config (of ``argv``'s ``--family``),
    seeded weights and service config for ``argv``, on the card."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    args = binary.build_parser().parse_args(argv)
    config, params = binary.builtin_model(args.family, args.seq_len,
                                          args.generate_tokens, "cuda")
    service_config = ServiceConfig(
        queue_url="", batch_size=args.batch_size, seq_len=args.seq_len,
        generate_tokens=args.generate_tokens,
        result_queue_url=args.result_queue_url, decode_block=decode_block,
    )
    return config, params, service_config


def block_cycles_phase(torch, smoke: Smoke, argv=GENERATE_ARGS,
                       label: str = "block 8") -> dict:
    """The continuous worker's cycles at decode block 8 (``argv``'s model
    family), driven one by one over the demo traffic: each may launch at
    most one decode and count at most one host transfer for the block plus
    one for each insert whose first tokens it settled (the reference's
    odometer; the port waits once for both); and the share of block
    settles at which the block dispatched that cycle was still running."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )

    config, params, service_config = demo_setup(torch, argv, 8)
    service_config.queue_url = "demo://queue"
    service_config.result_queue_url = ""
    queue = FakeMessageQueue()
    for body in demo_bodies(64):
        queue.send_message(service_config.queue_url, body)
    worker = ContinuousWorker(queue, params, config, service_config,
                              device="cuda")
    batcher = worker.batcher
    worst_dispatches, over = 0, []
    cycles = 0
    while worker.processed < 64 and cycles < 1000:
        before = (batcher.decode_dispatches, batcher.host_transfers,
                  batcher.insert_dispatches)
        worker.run_once()
        cycles += 1
        # a cycle's refill runs before its step, which settles its firsts
        settled = batcher.insert_dispatches - before[2]
        transfers = batcher.host_transfers - before[1]
        worst_dispatches = max(worst_dispatches,
                               batcher.decode_dispatches - before[0])
        if transfers > 1 + settled:
            over.append((cycles, transfers, settled))
    smoke.check(worker.processed == 64 and worst_dispatches <= 1 and not over,
                f"{label}: {worker.processed} of 64 served in {cycles} "
                f"cycles, at most {worst_dispatches} decode dispatch a cycle "
                f"(want <= 1); cycles counting more host transfers than 1 + "
                f"the inserts settled (cycle, transfers, settled): {over}; "
                f"{batcher.host_transfers} transfers for "
                f"{batcher.insert_dispatches} inserts and "
                f"{batcher.decode_dispatches} blocks")
    share = batcher.overlapped_settles / max(1, batcher.block_settles)
    cache_mib = sum(t.numel() * t.element_size()
                    for t in flat_params(batcher.cache["layers"])) / 2 ** 20
    print(f"{label}: {batcher.overlapped_settles} of {batcher.block_settles} "
          f"block settles found the next block still running "
          f"({100 * share:.1f}%), block utilization "
          f"{batcher.block_tokens / batcher.block_capacity:.4f}, KV cache "
          f"{cache_mib:.3f} MiB for {len(batcher.slots)} slots", flush=True)
    return {"cycles": cycles, "overlapped_settles": batcher.overlapped_settles,
            "block_settles": batcher.block_settles, "overlap_share": share,
            "cache_mib": cache_mib}


def greedy_margins(torch, params, config, prompt, tokens, forward=None):
    """The top-two margin of the logits that chose each of ``tokens``
    (one dense-attention ``forward`` over the prompt and its
    continuation; the GPT's by default)."""
    if forward is None:
        from kube_sqs_autoscaler_tpu_torch.workloads.model import forward

    seq = torch.cat([prompt, tokens])[None]
    logits = forward(params, seq, config)[0, len(prompt) - 1:-1]
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def staggered_phase(torch, flash, smoke: Smoke) -> dict:
    """The continuous batcher at the built-in GPT's full width in f32:
    24 prompts of ragged lengths (7 to 512) submitted a few at a time, so
    slots refill while others decode, at decode blocks 1 and 8; each
    request against the port's ``generate`` for its prompt alone, up to
    the first position where the tokens' top-two margin is below 1e-4."""
    from kube_sqs_autoscaler_tpu_torch.workloads import decode
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import builtin_config
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.model import init_params

    config = dataclasses.replace(builtin_config(512, 32), dtype=torch.float32)
    params = init_params(config, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(5)
    lengths = np.linspace(7, 512, 24).round().astype(int)
    requests = [rng.integers(0, config.vocab_size, n) for n in lengths]
    want, near_tie = [], []
    with torch.inference_mode():
        for ids in requests:
            prompt = torch.from_numpy(ids).cuda()
            tokens = decode.generate(params, prompt[None], 32, config,
                                     attention_fn=flash.flash_attention)[0]
            margins = greedy_margins(torch, params, config, prompt, tokens)
            low = np.flatnonzero(margins < MARGIN)
            want.append(tokens.cpu().numpy())
            near_tie.append(int(low[0]) if low.size else None)
    out = {}
    for block in (1, 8):
        batcher = ContinuousBatcher(params, config, 8, 512, 32,
                                    decode_block=block, device="cuda")
        before = flash.kernel_launches
        got, cycle = staggered_drive(batcher, requests)
        bad = []
        for i, tokens in got.items():
            upto = 32 if near_tie[i] is None else near_tie[i]
            if not np.array_equal(tokens[:upto], want[i][:upto]):
                bad.append(i)
        launched = flash.kernel_launches - before
        ties = {i: p for i, p in enumerate(near_tie) if p is not None}
        smoke.check(
            len(got) == 24 and not bad
            and launched == 4 * batcher.insert_dispatches,
            f"f32 staggered block {block}: {len(got)} of 24 requests in "
            f"{cycle} cycles and {batcher.insert_dispatches} inserts "
            f"({launched} flash_fwd launches); tokens equal to generate "
            f"alone up to the first near-tie (margin < {MARGIN:g}): "
            f"mismatched {bad}; near-ties (request: position) {ties}")
        out[block] = {"cycles": cycle, "mismatched": bad,
                      "inserts": batcher.insert_dispatches}
    out["near_ties"] = near_tie
    # the shards phase runs the same requests through a 4-shard plane
    out["inputs"] = {"config": config, "params": params,
                     "requests": requests, "want": want}
    return out


def staggered_drive(batcher, requests, every: int = 3):
    """Submit ``requests`` at most 3 at a time every ``every`` cycles while
    the others decode, until all finish; returns ``(tokens by request,
    cycles)``."""
    waiting, got, cycle = list(enumerate(requests)), {}, 0
    while (waiting or batcher.active) and cycle < 5000:
        free = len(batcher.free_slots)
        if waiting and free and cycle % every == 0:
            take = min(free, 3)
            batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
        for i, tokens in batcher.step():
            got[i] = tokens
        cycle += 1
    return got, cycle


def serve_profile_phase(torch) -> dict:
    """Where the continuous engine's time goes: ``torch.profiler`` around
    a 16-message drain at decode blocks 1 and 8 (weights already on the
    card)."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary

    out = {}
    for block in (1, 8):
        config, params, service_config = demo_setup(torch, GENERATE_ARGS,
                                                    block)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            summary = binary.run_demo(16, params, config, service_config,
                                      torch.device("cuda"), continuous=True)
            torch.cuda.synchronize()
        wall_ms = summary["elapsed_s"] * 1e3
        kernels, copies = device_breakdown(prof)
        busy_ms = sum(ms for ms, _, _ in kernels)
        flash_ms = sum(ms for ms, _, key in kernels if "flash_fwd" in key)
        print(f"profile continuous block {block} (16 messages, profiler on): "
              f"wall {wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), flash_fwd {flash_ms:.3f} ms, "
              f"copies {sum(ms for ms, _, _ in copies):.3f} ms "
              f"(x{sum(count for _, count, _ in copies)})", flush=True)
        for ms, count, key in kernels[:8]:
            print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
        out[block] = {"wall_ms": wall_ms, "kernel_busy_ms": busy_ms,
                      "flash_ms": flash_ms,
                      "top": [(ms, count, key[:90])
                              for ms, count, key in kernels[:8]]}
    return out


def f32_prefill_phase(torch, flash, smoke: Smoke) -> dict:
    from kube_sqs_autoscaler_tpu_torch.workloads import decode
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import builtin_config
    from kube_sqs_autoscaler_tpu_torch.workloads.model import (
        _dense_attention, init_params,
    )

    config = dataclasses.replace(builtin_config(512, 32), dtype=torch.float32)
    params = init_params(config, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, config.vocab_size, (8, 512), generator=g,
                        device="cuda")
    lengths = torch.tensor([512, 500, 384, 257, 128, 64, 33, 16],
                           device="cuda")
    with torch.inference_mode():
        got, _ = decode.prefill(params, ids, config, flash.flash_attention,
                                lengths=lengths)
        want, _ = decode.prefill(params, ids, config, _dense_attention,
                                 lengths=lengths)
    err = (got - want).abs().max().item()
    top = want.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    decided = margin > 1e-4
    same = (got.argmax(-1) == want.argmax(-1))[decided].all().item()
    smoke.check(err <= 1e-4, f"f32 prefill logits, kernel vs dense: "
                f"max|d|={err:.3e} tol=1e-4")
    smoke.check(bool(same), f"f32 prefill greedy first tokens identical on "
                f"{int(decided.sum())} of 8 rows with top-2 margin > 1e-4 "
                f"(min margin {margin.min().item():.3e})")
    return {"max_abs_err": err}


def scaled_err(got, want) -> tuple[float, float]:
    """``(max |got - want|, that over max(1, max |want|))``."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def train_inputs(torch, b, h, hkv, sq, sk, d, dtype, strided, seed):
    """q, k, v, dout on the card; ``strided`` takes q, k, v as head views
    of one fused [B, S, 3 * H * D] projection and dout as a head view of a
    [B, S, H * D] gradient, as the model's backward hands them over."""
    if strided:
        q, k, v = make_qkv(torch, b, h, hkv, sq, d, dtype, True, seed)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn((b, h, sq, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dout = torch.randn((b, sq, h * d), generator=g, device="cuda").to(dtype)
    dout = dout.reshape(b, sq, h, d).transpose(1, 2)
    return q, k, v, dout


def train_kernel_phase(torch, flash, smoke: Smoke) -> dict:
    """The lse forward and both backward halves against their plain
    versions at every listed case, then timed at the train shape."""
    import torch.nn.functional as F

    cases = [
        # (label, B, H, H_kv, S_q, S_k, D, causal, window, q_shift,
        #  strided, dlse)
        ("train", *TRAIN_SHAPE[:2], TRAIN_SHAPE[1], TRAIN_SHAPE[2],
         TRAIN_SHAPE[2], TRAIN_SHAPE[3], True, None, 0, True, False),
        ("gqa-h8-kv2-d128", 2, 8, 2, 512, 512, 128, True, None, 0, False,
         False),
        ("window128", 2, 8, 8, 1024, 1024, 64, True, 128, 0, False, False),
        ("non-causal", 2, 8, 8, 512, 512, 64, False, None, 0, False, False),
        ("rect-sq512-sk1024-shift512-dlse", 2, 8, 8, 512, 1024, 64, True,
         None, 512, False, True),
        ("window200-shift512-gqa-d128", 2, 4, 2, 256, 768, 128, True, 200,
         512, False, True),
        ("ragged-s1000", 2, 8, 8, 1000, 1000, 64, True, None, 0, False,
         False),
        ("ragged-s48", 2, 8, 8, 48, 48, 64, True, None, 0, False, False),
        ("ragged-s7", 2, 8, 8, 7, 7, 64, True, None, 0, False, False),
        ("gqa-h8-kv2-d128-s2048", 2, 8, 2, 2048, 2048, 128, True, None, 0,
         False, False),
    ]
    errs = {name: 0.0 for name in ("flash_fwd_lse", "flash_bwd_dq",
                                   "flash_bwd_dkv")}
    for seed, (label, b, h, hkv, sq, sk, d, causal, window, shift, strided,
               with_dlse) in enumerate(cases):
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            q, k, v, dout = train_inputs(torch, b, h, hkv, sq, sk, d, dtype,
                                         strided, 100 + seed)
            opts = dict(causal=causal, window=window, q_shift=shift)
            out, lse = flash.flash_fwd(q, k, v, need_lse=True, **opts)
            want_out, want_lse = flash.flash_fwd_reference(q, k, v, **opts)
            dlse = None
            if with_dlse:
                g = torch.Generator(device="cuda").manual_seed(seed)
                dlse = torch.randn(lse.shape, generator=g, device="cuda")
            delta = flash.attention_delta(want_out, dout, dlse)
            args = (q, k, v, dout, want_lse, delta)
            dq = flash.flash_bwd_dq(*args, **opts)
            dk, dv = flash.flash_bwd_dkv(*args, **opts)
            want_dq = flash.flash_bwd_dq_reference(*args, **opts)
            want_dk, want_dv = flash.flash_bwd_dkv_reference(*args, **opts)
            torch.cuda.synchronize()
            tol = TOL[dtype_name]
            results = {
                "flash_fwd_lse": [scaled_err(out, want_out),
                                  scaled_err(lse, want_lse)],
                "flash_bwd_dq": [scaled_err(dq, want_dq)],
                "flash_bwd_dkv": [scaled_err(dk, want_dk),
                                  scaled_err(dv, want_dv)],
            }
            shapes_ok = (dk.shape == k.shape and dv.shape == v.shape
                         and dq.shape == q.shape and lse.shape == q.shape[:3])
            for name, pairs in results.items():
                finite = all(bool(torch.isfinite(t).all().item()) for t in (
                    (out, lse) if name == "flash_fwd_lse" else
                    (dq,) if name == "flash_bwd_dq" else (dk, dv)))
                worst = max(scaled for _, scaled in pairs)
                raw = max(err for err, _ in pairs)
                smoke.check(
                    finite and shapes_ok and worst <= tol,
                    f"{name} {label} {dtype_name} B={b} H={h} H_kv={hkv} "
                    f"S_q={sq} S_k={sk} D={d} causal={causal} "
                    f"window={window} q_shift={shift} dlse={with_dlse}: "
                    f"max|d|={raw:.3e}, /max(1,|want|)={worst:.3e} "
                    f"tol={tol:g} ({TRAIN_TOL_REASON[dtype_name]})",
                )
                if dtype_name == "bfloat16" and label == "train":
                    errs[name] = raw
            if dtype_name == "bfloat16" and label == "train":
                # the backward fed from the forward kernel's own out and
                # lse, against the plain backward fed from the plain ones
                own = (q, k, v, dout, lse, flash.attention_delta(out, dout))
                own_dq = flash.flash_bwd_dq(*own, **opts)
                own_dk, own_dv = flash.flash_bwd_dkv(*own, **opts)
                fed = {"flash_bwd_dq": [scaled_err(own_dq, want_dq)],
                       "flash_bwd_dkv": [scaled_err(own_dk, want_dk),
                                         scaled_err(own_dv, want_dv)]}
                torch.cuda.synchronize()
                for name, pairs in fed.items():
                    worst = max(scaled for _, scaled in pairs)
                    smoke.check(
                        worst <= tol,
                        f"{name} {label} bf16 from the forward kernel's own "
                        f"out and lse vs the plain backward from the plain "
                        f"forward's: max|d|={max(e for e, _ in pairs):.3e}, "
                        f"/max(1,|want|)={worst:.3e} tol={tol:g} "
                        f"({TRAIN_TOL_REASON[dtype_name]})")

    b, h, s, d = TRAIN_SHAPE
    q, k, v, dout = train_inputs(torch, b, h, h, s, s, d, torch.bfloat16,
                                 True, 99)
    out, lse = flash.flash_fwd_reference(q, k, v)
    delta = flash.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, dout))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qc, kc, vc))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_backward():
        torch.autograd.grad(sdpa_out, (qg, kg, vg), doc, retain_graph=True)

    sdpa_bwd_ms = time_ms(torch, sdpa_backward)
    timings = {
        "flash_fwd": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_fwd(q, k, v)),
            plain_ms=time_ms(torch, lambda: flash.flash_fwd_reference(
                q, k, v)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True)),
            library_call="F.scaled_dot_product_attention forward",
            kind="fwd"),
        "flash_fwd_lse": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_fwd(
                q, k, v, need_lse=True)),
            plain_ms=time_ms(torch, lambda: flash.flash_fwd_reference(
                q, k, v)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True)),
            library_call="F.scaled_dot_product_attention forward",
            kind="fwd_lse"),
        "flash_bwd_dq": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_bwd_dq(*args)),
            plain_ms=time_ms(torch, lambda: flash.flash_bwd_dq_reference(
                *args)),
            library_ms=sdpa_bwd_ms,
            library_call="F.scaled_dot_product_attention backward alone "
                         "(dq, dk and dv together)",
            kind="dq"),
        "flash_bwd_dkv": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_bwd_dkv(*args)),
            plain_ms=time_ms(torch, lambda: flash.flash_bwd_dkv_reference(
                *args)),
            library_ms=sdpa_bwd_ms,
            library_call="F.scaled_dot_product_attention backward alone "
                         "(dq, dk and dv together)",
            kind="dkv"),
    }
    for name, t in timings.items():
        kind = t.pop("kind")
        t["bound_ms"], t["bound_by"] = flash_bound_ms(
            TRAIN_SHAPE, h, "bfloat16", kind=kind)
        t["tflops"] = flash_ops(TRAIN_SHAPE, kind=kind) / t["kernel_ms"] / 1e9
        print(f"time {name} bf16 {TRAIN_SHAPE}: kernel {t['kernel_ms']:.4f} "
              f"ms ({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.4f} "
              f"ms, library {t['library_ms']:.4f} ms ({t['library_call']}), "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    pair = timings["flash_bwd_dq"]["kernel_ms"] + \
        timings["flash_bwd_dkv"]["kernel_ms"]
    print(f"time backward pair bf16 {TRAIN_SHAPE}: dq + dk/dv kernels "
          f"{pair:.4f} ms, SDPA backward {sdpa_bwd_ms:.4f} ms "
          f"({pair / sdpa_bwd_ms:.1f}x)", flush=True)
    return {"errs": errs, "timings": timings}


def f32_train_phase(torch, flash, smoke: Smoke) -> dict:
    """The loss and every gradient of the training objective at the
    flagship width (2 layers, B=2, S=2048, fp32) through the kernels
    against the same through dense attention."""
    from kube_sqs_autoscaler_tpu_torch.workloads import train
    from kube_sqs_autoscaler_tpu_torch.workloads.model import (
        ModelConfig, _dense_attention, init_params,
    )

    config = ModelConfig(vocab_size=8192, d_model=1024, n_heads=16,
                         n_layers=2, d_ff=4096, max_seq_len=2048,
                         dtype=torch.float32)
    state = train.train_state(
        init_params(config, torch.Generator().manual_seed(0), "cuda"),
        train.TrainConfig())
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, config.vocab_size, (2, 2048), generator=g,
                           device="cuda")
    results = {}
    for name, attend in (("kernels", flash.flash_attention),
                         ("dense", _dense_attention)):
        before = (flash.lse_launches, flash.dq_launches, flash.dkv_launches)
        loss = partial(train.loss_fn, config=config, attention_fn=attend)
        results[name] = train.value_and_grad(loss, state["params"], tokens)
        launched = [now - then for now, then in zip(
            (flash.lse_launches, flash.dq_launches, flash.dkv_launches),
            before)]
        want = [config.n_layers] * 3 if name == "kernels" else [0] * 3
        smoke.check(launched == want, f"f32 train step through {name}: "
                    f"lse/dq/dkv launches {launched}")
    (loss_k, grads_k), (loss_d, grads_d) = results["kernels"], results["dense"]
    rel = abs(loss_k.item() - loss_d.item()) / abs(loss_d.item())
    smoke.check(rel <= 1e-5, f"f32 train loss, kernels {loss_k.item():.7f} vs "
                f"dense {loss_d.item():.7f}: rel {rel:.3e} tol=1e-5 (fp32 "
                "sums in another order)")
    worst = 0.0
    leaves_k = train.param_leaves(grads_k)
    leaves_d = train.param_leaves(grads_d)
    for got, want in zip(leaves_k, leaves_d):
        worst = max(worst, (got - want).abs().max().item()
                    / want.abs().max().item())
    smoke.check(worst <= 1e-4, f"f32 train grads, kernels vs dense, "
                f"{len(leaves_k)} tensors: worst max|d| / max|want| = "
                f"{worst:.3e} tol=1e-4 (fp32 sums in another order through "
                "two layers, and the softmax backward recomputed from the "
                "lse where the dense path differentiates its softmax)")
    return {"loss_rel_err": rel, "grad_rel_err": worst}


def counts(flash) -> dict:
    return {"flash_fwd": flash.kernel_launches,
            "flash_fwd_lse": flash.lse_launches,
            "flash_bwd_dq": flash.dq_launches,
            "flash_bwd_dkv": flash.dkv_launches}


def zero_counts(flash) -> None:
    flash.kernel_launches = flash.lse_launches = 0
    flash.dq_launches = flash.dkv_launches = 0


def train_path_phase(torch, flash, smoke: Smoke, power: str) -> dict:
    """The trainer binary's code path in-process at the flagship config in
    bf16: 10 ``--overfit`` steps with a held-out eval every 5, then 2
    steps under ``--remat``; launch counts zeroed just before each run and
    read just after."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    out = {}
    for run, extra, steps in (
            ("train", ["--eval-every", str(EVAL_EVERY), "--eval-batches",
                       "1"], TRAIN_STEPS),
            ("remat", ["--remat"], 2)):
        argv = [*TRAIN_ARGS, "--steps", str(steps), "--log-every", "1",
                "--overfit", *extra]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(flash)
        summary = trainer.main(argv)
        torch.cuda.synchronize()
        launched = counts(flash)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = summary["losses"]
        smoke.check(len(losses) == steps and all(map(math.isfinite, losses))
                    and losses[-1] < losses[0],
                    f"{run}: {steps} losses, finite and falling: "
                    f"{[round(x, 4) for x in losses]}")
        smoke.check(summary["final_step"] == steps,
                    f"{run}: final_step {summary['final_step']}")
        per_step = TRAIN_LAYERS * steps
        want = {
            "flash_fwd": TRAIN_LAYERS * (steps // EVAL_EVERY)
            if run == "train" else 0,
            "flash_fwd_lse": per_step * (2 if run == "remat" else 1),
            "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step,
        }
        smoke.check(launched == want, f"{run}: launches {launched}, want "
                    f"{want} (n_layers x steps; the forward twice under "
                    f"remat; the no-lse forward in eval passes only)")
        step_ms = 1e3 / summary["steps_per_s"]
        mfu = summary["mfu"]
        print(f"{run}: steady step {step_ms:.3f} ms over {steps - 1} steps, "
              f"{summary['tokens_per_s']:.1f} tokens/s, MFU "
              f"{'not known' if mfu is None else f'{100 * mfu:.2f}%'} of "
              f"the H100 bf16 dense peak (card: {power}), peak memory "
              f"{peak_gib:.3f} GiB", flush=True)
        out[run] = {"losses": losses, "launches": launched,
                    "step_ms": step_ms, "tokens_per_s":
                    summary["tokens_per_s"], "mfu": mfu,
                    "peak_gib": peak_gib}
    return out


def train_profile_phase(torch) -> dict:
    """Where one warm flagship train step's time goes: ``torch.profiler``
    over one step after two warm ones."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads import trainer
    from kube_sqs_autoscaler_tpu_torch.workloads.data import (
        synthetic_token_stream,
    )

    run = trainer.setup(trainer.build_parser().parse_args(TRAIN_ARGS))
    state, step_fn = run["state"], run["step_fn"]
    tokens = torch.from_numpy(next(synthetic_token_stream(
        8192, TRAIN_SHAPE[0], TRAIN_SHAPE[2], seed=0))).cuda()
    for _ in range(2):
        state, loss = step_fn(state, tokens)
    float(loss)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, loss = step_fn(state, tokens)
        float(loss)
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels, copies = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    by_name = {name: sum(ms for ms, _, key in kernels if name in key)
               for name in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkv_kernel")}
    print(f"profile train step (profiler on): wall {wall_ms:.3f} ms, kernels "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_name.items())
          + f", attention kernels {100 * sum(by_name.values()) / busy_ms:.1f}%"
          f" of busy, copies {sum(ms for ms, _, _ in copies):.3f} ms",
          flush=True)
    for ms, count, key in kernels[:12]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:100]}", flush=True)
    return {"wall_ms": wall_ms, "kernel_busy_ms": busy_ms, **by_name,
            "top": [(ms, count, key[:100]) for ms, count, key in kernels[:12]]}


class SqsEmulator:
    """A local SQS endpoint on 127.0.0.1: the JSON protocol
    (``AmazonSQS.SendMessage``, ``ReceiveMessage``, ``DeleteMessage``,
    ``ChangeMessageVisibility``, ``GetQueueAttributes``) over the port's
    ``FakeMessageQueue``, one queue per ``QueueUrl``.  A receive returns up
    to ``MaxNumberOfMessages`` at once and never blocks (``WaitTimeSeconds``
    is ignored).  Counts the calls that came without a SigV4 signature."""

    def __init__(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.queues: dict = {}
        self.unsigned = 0
        self.calls: dict[str, int] = {}
        emulator = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self) -> None:  # noqa: N802 (http.server API)
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                action = self.headers.get("X-Amz-Target", "")
                if not self.headers.get("Authorization", "").startswith(
                        "AWS4-HMAC-SHA256 "):
                    emulator.unsigned += 1
                status, reply = emulator.handle(
                    action.removeprefix("AmazonSQS."), body)
                data = json.dumps(reply).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/x-amz-json-1.0")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args) -> None:
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def queue(self, name: str):
        """``(url, FakeMessageQueue)`` of the queue at ``/<name>``."""
        from kube_sqs_autoscaler_tpu_torch.metrics.fake import (
            FakeMessageQueue,
        )

        url = f"{self.url}/{name}"
        return url, self.queues.setdefault(url, FakeMessageQueue())

    def handle(self, action: str, body: dict) -> tuple[int, dict]:
        self.calls[action] = self.calls.get(action, 0) + 1
        url = body.get("QueueUrl", "")
        queue = self.queues.get(url)
        if queue is None:
            return 400, {"__type": "com.amazonaws.sqs#QueueDoesNotExist"}
        if action == "SendMessage":
            return 200, {"MessageId": queue.send_message(
                url, body["MessageBody"])}
        if action == "ReceiveMessage":
            return 200, {"Messages": queue.receive_messages(
                url, max_messages=int(body.get("MaxNumberOfMessages", 1)))}
        if action == "DeleteMessage":
            queue.delete_message(url, body["ReceiptHandle"])
            return 200, {}
        if action == "ChangeMessageVisibility":
            queue.change_message_visibility(
                url, body["ReceiptHandle"], body["VisibilityTimeout"])
            return 200, {}
        if action == "GetQueueAttributes":
            return 200, {"Attributes": queue.get_queue_attributes(
                url, body.get("AttributeNames", ()))}
        return 400, {"__type": "com.amazonaws.sqs#InvalidAction"}

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


# The worker binary in a child process with the flash launch counts printed
# at exit: SIGTERM (how a Deployment stops a replica) ends its serve loop.
SQS_CHILD = """
import json, signal, sys
from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary, flash

def stop(signum, frame):
    raise SystemExit(0)

signal.signal(signal.SIGTERM, stop)
try:
    binary.main(sys.argv[1:])
finally:
    print("LAUNCHES " + json.dumps({
        "flash_fwd": flash.kernel_launches, "flash_fwd_lse": flash.lse_launches,
        "flash_bwd_dq": flash.dq_launches, "flash_bwd_dkv": flash.dkv_launches,
    }), flush=True)
"""
# placeholder credentials: with them in the environment the client never
# probes the instance-metadata endpoint
LOCAL_AWS_ENV = {"AWS_ACCESS_KEY_ID": "AKIDLOCALEMULATOR",
                 "AWS_SECRET_ACCESS_KEY": "local-emulator-secret"}
ROOT = Path(__file__).resolve().parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drain_raw(queue, url: str) -> dict[str, list[str]]:
    """Every visible message body of ``queue``, deleted as read, grouped
    by its ``request_id``."""
    out: dict[str, list[str]] = {}
    while True:
        batch = queue.receive_messages(url, max_messages=64)
        if not batch:
            return out
        for message in batch:
            queue.delete_message(url, message["ReceiptHandle"])
            rid = json.loads(message["Body"]).get("request_id", "")
            out.setdefault(rid, []).append(message["Body"])


def stop_child(child, timeout: float = 60.0) -> str:
    """SIGTERM, then SIGKILL after ``timeout``; returns its output."""
    if child.poll() is None:
        child.terminate()
    try:
        out, _ = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        out, _ = child.communicate()
    return out or ""


class SqsRun:
    """The worker binary on its own emulator: 64 demo bodies loaded, the
    binary started as a child process, and a watcher thread that scrapes
    ``/metrics`` once two batches are answered and notes when all 64 are
    answered and deleted.  :meth:`finish` then terminates the child and
    checks the run."""

    def __init__(self, mode: str, extra: list[str]) -> None:
        self.mode, self.extra = mode, extra
        self.emulator = SqsEmulator()
        self.jobs_url, self.jobs = self.emulator.queue("000000000000/jobs")
        self.replies_url, self.replies = self.emulator.queue(
            "000000000000/replies")
        self.sent = [self.jobs.send_message(self.jobs_url, body)
                     for body in demo_bodies(64)]
        self.port = free_port()
        argv = ["--sqs-queue-url", self.jobs_url, "--aws-region",
                "us-east-1", "--batch-size", "8", "--seq-len", "512",
                "--generate-tokens", "32", "--result-queue-url",
                self.replies_url, "--metrics-port", str(self.port),
                "--device", "cuda", *extra]
        self.scrape, self.first_reply_s, self.done_s = "", None, None
        self.start = time.perf_counter()
        self.child = subprocess.Popen(
            [sys.executable, "-c", SQS_CHILD, *argv], cwd=ROOT,
            env={**os.environ, **LOCAL_AWS_ENV}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self) -> None:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and self.child.poll() is None:
            answered = int(self.replies.get_queue_attributes(
                self.replies_url, ())["ApproximateNumberOfMessages"])
            attrs = self.jobs.get_queue_attributes(self.jobs_url, ())
            if answered and self.first_reply_s is None:
                self.first_reply_s = time.perf_counter() - self.start
            if answered >= 16 and not self.scrape:
                # two batches in: the batch worker's first cycle span has
                # closed, the continuous engine has settled TTFT samples
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{self.port}/metrics",
                        timeout=10) as r:
                    self.scrape = r.read().decode()
            if (answered >= 64 and attrs["ApproximateNumberOfMessages"] == "0"
                    and attrs["ApproximateNumberOfMessagesNotVisible"] == "0"):
                self.done_s = time.perf_counter() - self.start
                return
            time.sleep(0.02)

    def finish(self, smoke: Smoke, want: dict[str, str]) -> dict:
        mode = self.mode
        try:
            self.watcher.join(timeout=330)
            output = stop_child(self.child)
            attrs = self.jobs.get_queue_attributes(self.jobs_url, ())
            got = drain_raw(self.replies, self.replies_url)
        finally:
            if self.child.poll() is None:
                stop_child(self.child, timeout=10)
            self.emulator.close()
        log = ROOT / "build" / "chip_smoke" / f"sqs-{mode}.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        log.write_text(output)
        found = [line for line in output.splitlines()
                 if line.startswith("LAUNCHES ")]
        launched = json.loads(found[-1].split(" ", 1)[1]) if found else {}
        duplicates = sum(len(bodies) - 1 for bodies in got.values())
        raw = {rid: bodies[0] for rid, bodies in got.items()}
        smoke.check(self.done_s is not None and self.child.returncode == 0
                    and bool(launched),
                    f"sqs {mode}: the binary answered 64 in {self.done_s} s "
                    f"(first reply at {self.first_reply_s} s, process start "
                    f"included) and exited {self.child.returncode} on "
                    f"SIGTERM (log: {log.relative_to(ROOT)}; its end: "
                    f"{output[-1500:] if self.done_s is None else '...'})")
        smoke.check(sorted(raw) == sorted(self.sent) and duplicates == 0
                    and attrs["ApproximateNumberOfMessages"] == "0"
                    and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                    f"sqs {mode}: {len(raw)} of {len(self.sent)} requests "
                    f"answered, {duplicates} duplicates, every input deleted "
                    f"({attrs})")
        same = sum(raw.get(rid) == body for rid, body in want.items())
        smoke.check(same == 64 and len(want) == 64,
                    f"sqs {mode}: {same} of 64 reply bodies byte-identical "
                    f"to the in-memory --demo 64 run's (bf16, greedy)")
        calls = self.emulator.calls
        smoke.check(self.emulator.unsigned == 0,
                    f"sqs {mode}: every call SigV4-signed "
                    f"({self.emulator.unsigned} unsigned); calls {calls}")
        families = ["worker_cycle_seconds_count"]
        if "--continuous" in self.extra:
            families += ["tokens_per_second", "time_to_first_token_seconds",
                         "active_slots", "decode_block_utilization",
                         'ttft_seconds_bucket{le="+Inf"}']
        missing = [f for f in families
                   if f"kube_sqs_autoscaler_workload_{f}" not in self.scrape]
        smoke.check(not missing, f"sqs {mode}: /metrics scraped mid-run "
                    f"({len(self.scrape)} bytes), missing families {missing}")
        smoke.check(launched.get("flash_fwd", 0) > 0
                    and launched.get("flash_fwd_lse") == 0,
                    f"sqs {mode}: launches {launched}")
        return {"launches": launched.get("flash_fwd", 0),
                "done_s": self.done_s, "first_reply_s": self.first_reply_s,
                "calls": calls}


def profiled_worker_run(torch, smoke: Smoke) -> dict:
    """A ``QueueWorker`` with ``profile_dir`` set serving one batch of 8
    demo messages from its ``run_forever`` loop: its first cycle is
    traced, and the trace must exist and name the ``flash_fwd`` kernel."""
    import shutil

    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import QueueWorker

    config, params, service_config = demo_setup(torch, GENERATE_ARGS)
    trace_dir = ROOT / "build" / "traces" / "queue-worker"
    shutil.rmtree(trace_dir, ignore_errors=True)
    service_config = dataclasses.replace(
        service_config, queue_url="demo://queue", result_queue_url="",
        profile_dir=str(trace_dir), profile_cycles=1, idle_sleep_s=0.01)
    queue = FakeMessageQueue()
    for body in demo_bodies(8):
        queue.send_message(service_config.queue_url, body)
    worker = QueueWorker(queue, params, config, service_config,
                         device="cuda")

    def watch():
        deadline = time.monotonic() + 120
        while worker.processed < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        worker.stop()

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    worker.run_forever()
    watcher.join()
    traces = sorted(trace_dir.glob("trace-*.json"))
    text = traces[0].read_text() if traces else ""
    named = text.count("flash_fwd_kernel")
    smoke.check(worker.processed == 8 and len(traces) == 1 and named > 0,
                f"profiled QueueWorker: {worker.processed} of 8 served, "
                f"{len(traces)} trace file(s) of {len(text)} bytes naming "
                f"flash_fwd_kernel {named} times")
    return {"trace_bytes": len(text), "flash_fwd_mentions": named}


def sqs_phase(torch, flash, smoke: Smoke, serve: dict) -> dict:
    """The worker binary against a real HTTP queue, the continuous engine
    at decode block 8 and the batch worker side by side (each child on its
    own emulator), each byte-identical to its in-memory ``--demo 64`` run;
    meanwhile the batch worker's profiler in this process."""
    runs = {mode: SqsRun(mode, extra) for mode, extra in (
        ("continuous-b8", ["--continuous", "--decode-block", "8"]),
        ("generate", []))}
    out = {}
    try:
        out["profile"] = profiled_worker_run(torch, smoke)
    finally:
        for mode, run in runs.items():
            out[mode] = run.finish(smoke, serve[mode]["replies"])
    return out


FLEET_QUEUE = "fleet://jobs"
FLEET_RESULTS = "fleet://replies"
# (cycle, replica): kill replica 1 and hang replica 2 while both are busy
FLEET_KILL = (8, 1)
FLEET_HANG = (11, 2)


def flat_params(params) -> list:
    if isinstance(params, dict):
        return [t for v in params.values() for t in flat_params(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in flat_params(v)]
    return [params]


def fleet_episode(torch, params, config, device="cuda") -> dict:
    """The deterministic fleet episode on one ``FakeClock``: the
    ``--demo 64`` traffic, ``WorkerPool.serving(min=1, max=3)`` at
    ``--batch-size 8 --seq-len 512 --generate-tokens 32 --decode-block
    8``, the binary's control loop (poll 0.1 s, up at 2 x 8 messages,
    down at 8, cooldowns 0.2 and 0.4 s), two fleet cycles a poll, and a
    fault plan that kills replica 1 and hangs replica 2 while they hold
    requests.  Runs until every request is answered and the fleet is back
    at min."""
    from kube_sqs_autoscaler_tpu_torch.core import (
        ControlLoop, FakeClock, LoopConfig, PolicyConfig,
    )
    from kube_sqs_autoscaler_tpu_torch.fleet import (
        DRAINING, FleetDriver, WorkerPool,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics import QueueMetricSource
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    clock = FakeClock()
    queue = FakeMessageQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    sent = [queue.send_message(FLEET_QUEUE, body)
            for body in demo_bodies(64, config.vocab_size)]
    service_config = ServiceConfig(
        queue_url=FLEET_QUEUE, batch_size=8, seq_len=512, generate_tokens=32,
        decode_block=8, result_queue_url=FLEET_RESULTS)
    pool = WorkerPool.serving(queue, params, config, service_config,
                              result_queue=results, min=1, max=3,
                              clock=clock, device=device)
    loop = ControlLoop(
        pool,
        QueueMetricSource(queue, FLEET_QUEUE, ("ApproximateNumberOfMessages",)),
        LoopConfig(poll_interval=0.1, policy=PolicyConfig(
            scale_up_messages=2 * 8, scale_down_messages=8,
            scale_up_cooldown=0.2, scale_down_cooldown=0.4)),
        clock=clock)
    plan = FleetFaultPlan(kills=(FLEET_KILL,), hangs=(FLEET_HANG,))
    busy_at_fault = {}

    class Recorded:
        """The plan, noting how many requests each target holds when its
        fault lands."""

        def apply(self, cycle, target):
            for at, index in (FLEET_KILL, FLEET_HANG):
                if at == cycle:
                    busy_at_fault[index] = \
                        target._member(index).worker.batcher.active
            plan.apply(cycle, target)

    driver = FleetDriver(pool, loop, cycle_dt=0.05, fault_plan=Recorded())
    stats = driver.run(max_cycles=3000, until=lambda: (
        pool.processed >= len(sent) and pool.idle
        and pool.replicas == pool.min
        and not any(r.state == DRAINING for r in pool.members)))
    return {"pool": pool, "stats": stats, "sent": sent,
            "replies": drain_raw(results, FLEET_RESULTS),
            "busy_at_fault": busy_at_fault, "queue": queue}


def check_fleet_episode(torch, smoke: Smoke, label: str, run: dict,
                        params) -> dict:
    """The episode's milestones: spawn, a kill with re-dispatch, a hang
    the watchdog declares dead, a drain back to min, every request
    answered once, the params shared."""
    pool, stats, sent = run["pool"], run["stats"], run["sent"]
    names = [e.name for e in pool.events]
    kills = {e.args["replica"]: e.args for e in pool.events
             if e.name == "replica-kill"}
    killed, hung = kills.get(FLEET_KILL[1], {}), kills.get(FLEET_HANG[1], {})
    smoke.check(names.count("replica-spawn") >= 3
                and max(stats["replica_trajectory"], default=0) >= 2,
                f"fleet {label}: {names.count('replica-spawn')} spawns, "
                f"trajectory {stats['replica_trajectory']}")
    smoke.check(killed.get("cause") == "killed"
                and killed.get("redispatched", 0) > 0,
                f"fleet {label}: replica {FLEET_KILL[1]} killed at cycle "
                f"{FLEET_KILL[0]} holding {run['busy_at_fault'].get(1)} "
                f"requests: {killed}")
    smoke.check(hung.get("cause") == "hung",
                f"fleet {label}: replica {FLEET_HANG[1]} hung at cycle "
                f"{FLEET_HANG[0]} holding {run['busy_at_fault'].get(2)} "
                f"requests, declared dead by the watchdog: {hung}")
    smoke.check("replica-drain-done" in names and pool.replicas == pool.min,
                f"fleet {label}: drained back to min {pool.min} "
                f"(serving {pool.replicas}, {names.count('replica-drain-done')}"
                f" drains done) in {stats['cycles']} cycles, "
                f"{stats['ticks']} ticks")
    duplicates = sum(len(b) - 1 for b in run["replies"].values())
    attrs = run["queue"].get_queue_attributes(FLEET_QUEUE, ())
    smoke.check(sorted(run["replies"]) == sorted(sent) and duplicates == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                f"fleet {label}: {len(run['replies'])} of {len(sent)} "
                f"requests answered, reply request_ids == sent MessageIds: "
                f"{sorted(run['replies']) == sorted(sent)}, {duplicates} "
                f"duplicates ({pool.duplicates_suppressed} suppressed, "
                f"{pool.redispatched_total} re-dispatched), queue {attrs}")
    ptrs = [t.data_ptr() for t in flat_params(params)]
    shared = all([t.data_ptr() for t in flat_params(r.worker.batcher.params)]
                 == ptrs for r in pool.members)
    smoke.check(shared, f"fleet {label}: all {len(pool.members)} replicas' "
                f"params share the pool's {len(ptrs)} data_ptrs")
    batchers = [r.worker.batcher for r in pool.members]
    return {"events": names, "trajectory": stats["replica_trajectory"],
            "cycles": stats["cycles"], "ticks": stats["ticks"],
            "members": len(pool.members),
            "overlapped_settles": sum(b.overlapped_settles for b in batchers),
            "block_settles": sum(b.block_settles for b in batchers),
            "redispatched": pool.redispatched_total,
            "duplicates_suppressed": pool.duplicates_suppressed,
            "inserts": sum(r.worker.batcher.insert_dispatches
                           for r in pool.members)}


def fleet_phase(torch, flash, smoke: Smoke, serve: dict) -> dict:
    """The pool on the card: (a) the deterministic episode in bf16, its
    launches zeroed just before and read just after, with its peak memory
    beside one replica's; (b) the same episode in f32, each reply against
    ``generate`` for its prompt alone up to the first near-tie; (c) the
    binary's ``--fleet-max-replicas 3`` on the real clock, timed, then
    again under ``torch.profiler``; (d) ``python -m
    kube_sqs_autoscaler_tpu_torch.fleet``, in its own process beside (a)
    and (b), collected before (c) so it does not share (c)'s clock."""
    out = {}
    demo = subprocess.Popen(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch.fleet"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out.update(fleet_episodes(torch, flash, smoke, serve))
    finally:
        demo_out = stop_child(demo, timeout=300) if demo.poll() is None \
            else demo.communicate()[0]
    last = (demo_out.strip().splitlines() or ["{}"])[-1]
    try:
        result = json.loads(last)
    except json.JSONDecodeError:
        result = {}
    smoke.check(demo.returncode == 0 and result.get("ok") is True
                and result.get("device", "").startswith("cuda"),
                f"python -m kube_sqs_autoscaler_tpu_torch.fleet exited "
                f"{demo.returncode}: {last[:400]}")
    out["demo"] = result
    out["binary"] = fleet_binary_run(torch, flash, smoke, serve)
    return out


def fleet_episodes(torch, flash, smoke: Smoke, serve: dict) -> dict:
    """Parts (a) and (b) of :func:`fleet_phase`."""
    from kube_sqs_autoscaler_tpu_torch.workloads import decode
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        builtin_config,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.model import init_params

    out = {}
    # (a) bf16, with one replica's peak memory first for comparison
    config, params, service_config = demo_setup(torch, GENERATE_ARGS, 8)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params_mb = sum(t.numel() * t.element_size()
                    for t in flat_params(params)) / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    queue = FakeMessageQueue()
    for body in demo_bodies(8):
        queue.send_message("demo://queue", body)
    single = ContinuousWorker(
        queue, params, config,
        dataclasses.replace(service_config, queue_url="demo://queue",
                            result_queue_url=""), device="cuda")
    single.drain(total=8)
    torch.cuda.synchronize()
    single_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    cache_mb = sum(t.numel() * t.element_size()
                   for t in flat_params(single.batcher.cache)) / 2 ** 20
    del single
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash)
    start = time.perf_counter()
    run = fleet_episode(torch, params, config)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launched = counts(flash)
    fleet_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    summary = check_fleet_episode(torch, smoke, "bf16", run, params)
    inserts = summary["inserts"]
    smoke.check(launched["flash_fwd"] == 4 * inserts
                and launched["flash_fwd_lse"] == 0,
                f"fleet bf16: flash_fwd launches {launched['flash_fwd']} = 4 "
                f"layers x {inserts} inserts over all members, lse "
                f"{launched['flash_fwd_lse']}")
    single_replies = serve["continuous-b8"]["replies"]
    same = sum(bodies[0] == single_replies.get(rid)
               for rid, bodies in run["replies"].items())
    print(f"fleet bf16: {same} of 64 replies byte-identical to the single "
          f"continuous-b8 worker's (refill sizes vary under re-dispatch); "
          f"{summary['members']} members, events {summary['events']}; "
          f"{summary['overlapped_settles']} of {summary['block_settles']} "
          f"block settles found the next block still running; "
          f"{elapsed:.3f} s of wall for {summary['cycles']} cycles", flush=True)
    print(f"fleet bf16 memory: params {params_mb:.3f} MiB (one copy), one "
          f"replica's KV cache {cache_mb:.3f} MiB; peak above the params: "
          f"one replica {single_mb:.3f} MiB, the fleet "
          f"({summary['members']} members, retired ones keep their caches) "
          f"{fleet_mb:.3f} MiB", flush=True)
    out["bf16"] = {**summary, "launches": launched["flash_fwd"],
                   "same_as_single": same, "wall_s": elapsed,
                   "params_mib": params_mb, "cache_mib": cache_mb,
                   "single_peak_mib": single_mb, "fleet_peak_mib": fleet_mb}
    del run, params

    # (b) f32: each reply against generate for its prompt alone
    config32 = dataclasses.replace(builtin_config(512, 32),
                                   dtype=torch.float32)
    params32 = init_params(config32, torch.Generator().manual_seed(0), "cuda")
    run = fleet_episode(torch, params32, config32)
    summary32 = check_fleet_episode(torch, smoke, "f32", run, params32)
    bodies = dict(zip(run["sent"], demo_bodies(64)))
    bad, ties = [], {}
    start = time.perf_counter()
    with torch.inference_mode():
        for rid, prompt_json in bodies.items():
            prompt = torch.tensor(json.loads(prompt_json), device="cuda")
            want = decode.generate(params32, prompt[None], 32, config32,
                                   attention_fn=flash.flash_attention)[0]
            margins = greedy_margins(torch, params32, config32, prompt, want)
            low = np.flatnonzero(margins < MARGIN)
            upto = int(low[0]) if low.size else 32
            if low.size:
                ties[rid] = upto
            got = json.loads(run["replies"].get(rid, ["{}"])[0])
            if got.get("tokens", [])[:upto] != want.cpu().tolist()[:upto]:
                bad.append(rid)
    smoke.check(not bad and len(run["replies"]) == 64,
                f"fleet f32: {64 - len(bad)} of 64 replies equal generate "
                f"alone up to the first near-tie (margin < {MARGIN:g}); "
                f"mismatched {bad}; near-ties (request: position) {ties} "
                f"({time.perf_counter() - start:.3f} s for the 64 generate "
                f"calls)")
    out["f32"] = {**summary32, "mismatched": bad, "near_ties": ties}
    return out


def fleet_binary_run(torch, flash, smoke: Smoke, serve: dict) -> dict:
    """Part (c) of :func:`fleet_phase`: the binary's closed loop on the
    real clock, timed, then again under ``torch.profiler`` (device
    activity only)."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    single_replies = serve["continuous-b8"]["replies"]
    argv = [*demo64(GENERATE_ARGS), "--continuous", "--decode-block", "8",
            "--fleet-max-replicas", "3", "--device", "cuda"]
    zero_counts(flash)
    binary = worker(argv)
    torch.cuda.synchronize()
    launched = counts(flash)
    smoke.check(binary["processed"] == 64 and len(binary["replies"]) == 64
                and binary["duplicate_replies"] == 0
                and launched["flash_fwd"] == 4 * binary["insert_dispatches"]
                and launched["flash_fwd_lse"] == 0,
                f"fleet binary: {binary['processed']} of 64 processed, "
                f"{len(binary['replies'])} replies, "
                f"{binary['duplicate_replies']} duplicates, flash_fwd "
                f"launches {launched['flash_fwd']} = 4 x "
                f"{binary['insert_dispatches']} inserts, lse "
                f"{launched['flash_fwd_lse']}")
    same = sum(json.dumps(body) == single_replies.get(rid)
               for rid, body in binary["replies"].items())
    # device activity only: the episode launches tens of thousands of
    # kernels, and recording their host operators too makes the trace's
    # post-processing take longer than the episode many times over
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = worker(argv)
        torch.cuda.synchronize()
    kernels, copies = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    copy_ms = sum(ms for ms, _, _ in copies)
    wall_ms = profiled["elapsed_s"] * 1e3
    flash_ms = sum(ms for ms, _, key in kernels if "flash_fwd" in key)
    ttft = binary["ttft_mean_s"]
    print(f"fleet binary --demo 64 --fleet-max-replicas 3 (real clock): "
          f"{binary['msgs_per_s']:.3f} msgs/s, {binary['tokens_per_s']:.3f} "
          f"generated tokens/s, mean TTFT "
          f"{'none' if ttft is None else f'{ttft * 1e3:.3f} ms'}, replica "
          f"trajectory {binary['replica_trajectory']} over "
          f"{binary['ticks']} ticks, {binary['elapsed_s']:.3f} s; {same} of "
          f"64 replies byte-identical to the single worker's; "
          f"{binary['overlapped_settles']} of {binary['block_settles']} block "
          f"settles found the next block still running", flush=True)
    print(f"profile fleet binary (profiler on): wall {wall_ms:.3f} ms, "
          f"kernels busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"flash_fwd {flash_ms:.3f} ms, copies {copy_ms:.3f} ms, trajectory "
          f"{profiled['replica_trajectory']}", flush=True)
    for ms, count, key in kernels[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    out = {k: binary[k] for k in (
        "msgs_per_s", "tokens_per_s", "ttft_mean_s", "replica_trajectory",
        "ticks", "elapsed_s", "insert_dispatches", "redispatched",
        "overlapped_settles", "block_settles")}
    out.update(launches=launched["flash_fwd"], same_as_single=same,
               busy_share=busy_ms / wall_ms, busy_ms=busy_ms,
               profiled_wall_ms=wall_ms, flash_ms=flash_ms)
    return out


# The sharded plane (shards phase): 4 engine shards of 8 slots behind one
# admission plane, one gang decode dispatch a cycle
SHARDS_ARGS = [*GENERATE_ARGS, "--continuous", "--decode-block", "8",
               "--shards", "4"]
CHAOS_QUEUE = "chaos://jobs"
CHAOS_RESULTS = "chaos://replies"
# the chaos episode's traffic (8 bodies at the start, then 4 a cycle up to
# 128, so a backlog outlasts every fault and probe), its faults as
# FleetFaultPlan entries ((start, end, shard) windows and one (cycle,
# shard) mask corruption) and the pool's probe delay in cycles
CHAOS_TOTAL, CHAOS_FIRST, CHAOS_PER_CYCLE = 128, 8, 4
CHAOS_POISON = (7, 11, 1)
CHAOS_WEDGE = (14, 20, 2)
CHAOS_MASK = (20, 3)
CHAOS_PROBE_AFTER = 4
RESUME_SEQ = 512 + 32  # a resumed row's prompt: 512 + what it produced


class recorded_shapes:
    """Within the block, the q shape of every ``flash_fwd`` call (the
    wrapper itself still launches and counts)."""

    def __init__(self, flash) -> None:
        self.flash, self.shapes = flash, []

    def __enter__(self) -> list:
        original = self.original = self.flash.flash_fwd

        def record(q, k, v, **kw):
            self.shapes.append(tuple(q.shape))
            return original(q, k, v, **kw)

        self.flash.flash_fwd = record
        return self.shapes

    def __exit__(self, *exc) -> None:
        self.flash.flash_fwd = self.original


def plane_worker(torch, params, config, service_config, shards, **kw):
    """A continuous worker over the sharded plane, the ``--demo 64``
    bodies queued."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )

    queue = FakeMessageQueue()
    for body in demo_bodies(64):
        queue.send_message("demo://queue", body)
    service_config = dataclasses.replace(
        service_config, queue_url="demo://queue", shards=shards,
        result_queue_url="demo://replies" if "result_queue" in kw else "")
    return queue, ContinuousWorker(queue, params, config, service_config,
                                   device="cuda", **kw)


def shards_phase(torch, flash, smoke: Smoke, serve: dict, stagger: dict,
                 fleet: dict) -> dict:
    """The sharded serving plane on the card: (a) a one-shard plane
    (``sharded=True``) against the block-8 worker, byte for byte; (b) the
    binary's ``--shards 4`` and the same plane driven cycle by cycle; (c)
    a 4-shard f32 plane over the staggered requests against ``generate``;
    (d) the chaos episode in bf16 and f32; (e) warm rates beside one
    worker and the 3-replica fleet, and a profiled plane drain."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
        ShardedBatcher,
    )

    out = {}
    single = serve["continuous-b8"]["replies"]
    config, params, service_config = demo_setup(torch, GENERATE_ARGS, 8)

    # (a) S = 1: the block-8 worker's shapes, so its replies exactly
    results = FakeMessageQueue()
    _, one = plane_worker(torch, params, config, service_config, 1,
                          result_queue=results, sharded=True)
    zero_counts(flash)
    one.drain(total=64)
    torch.cuda.synchronize()
    launched = counts(flash)
    replies = {rid: bodies[0] for rid, bodies in
               drain_raw(results, "demo://replies").items()}
    inserts = one.batcher.insert_dispatches
    smoke.check(isinstance(one.batcher, ShardedBatcher)
                and one.batcher.shards == 1 and replies == single
                and launched["flash_fwd"] == 4 * inserts
                and launched["flash_fwd_lse"] == 0,
                f"shards S=1 plane (sharded=True) bf16 block 8: "
                f"{sum(replies.get(r) == b for r, b in single.items())} of "
                f"{len(single)} replies byte-identical to the block-8 "
                f"worker's; flash_fwd launches {launched['flash_fwd']} = 4 x "
                f"{inserts} inserts, lse {launched['flash_fwd_lse']}")
    out["s1"] = {"launches": launched["flash_fwd"], "inserts": inserts,
                 "identical": sum(replies.get(r) == b
                                  for r, b in single.items())}
    del one

    # (b) the binary's --shards 4, then the same plane cycle by cycle
    zero_counts(flash)
    summary = worker([*demo64(SHARDS_ARGS), "--device", "cuda"])
    torch.cuda.synchronize()
    launched = counts(flash)
    attrs = summary["queue_attributes"]
    inserts = summary["insert_dispatches"]
    smoke.check(summary["processed"] == 64 and len(summary["replies"]) == 64
                and summary["duplicate_replies"] == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                f"shards binary --shards 4: processed {summary['processed']} "
                f"of 64, {len(summary['replies'])} replies, "
                f"{summary['duplicate_replies']} duplicates, queue {attrs}")
    smoke.check(launched["flash_fwd"] == 4 * inserts
                and launched["flash_fwd_lse"] == 0
                and summary["gang_cycles"] == summary["decode_dispatches"]
                and summary["summary_transfers"] == summary["block_settles"],
                f"shards binary: flash_fwd launches {launched['flash_fwd']} = "
                f"4 x {inserts} inserts, lse {launched['flash_fwd_lse']}; "
                f"{summary['gang_cycles']} gang cycles = "
                f"{summary['decode_dispatches']} decode dispatches; "
                f"{summary['summary_transfers']} summary transfers = "
                f"{summary['block_settles']} settled blocks")
    same = sum(json.dumps(body) == single.get(rid)
               for rid, body in summary["replies"].items())
    print(f"shards binary: {same} of 64 replies byte-identical to the single "
          f"block-8 worker's (not gated: the plane's [32, 512] decode GEMMs "
          f"may take other cuBLAS kernels than [8, 512]); "
          f"{summary['host_transfers']} host transfers", flush=True)
    out["binary"] = {"launches": launched["flash_fwd"], "inserts": inserts,
                     "same_as_single": same,
                     **{k: summary[k] for k in (
                         "decode_dispatches", "gang_cycles",
                         "host_transfers", "summary_transfers",
                         "block_settles", "overlapped_settles")}}

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, plane = plane_worker(torch, params, config, service_config, 4)
    batcher = plane.batcher
    cycles, busy_cycles, bad_dispatch, over = 0, 0, [], []
    while plane.processed < 64 and cycles < 1000:
        before = (batcher.decode_dispatches, batcher.host_transfers,
                  batcher.insert_dispatches, batcher.active)
        plane.run_once()
        cycles += 1
        busy = before[3] > 0 or batcher.insert_dispatches > before[2]
        busy_cycles += busy
        if batcher.decode_dispatches - before[0] != int(busy):
            bad_dispatch.append(cycles)
        if batcher.host_transfers - before[1] > 1:
            over.append(cycles)
    torch.cuda.synchronize()
    plane_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    cache_mb = sum(t.numel() * t.element_size()
                   for t in flat_params(batcher.cache)) / 2 ** 20
    smoke.check(plane.processed == 64 and not bad_dispatch and not over,
                f"shards cycles: {plane.processed} of 64 in {cycles} cycles, "
                f"{busy_cycles} busy; cycles without exactly one gang "
                f"dispatch when busy (none when idle): {bad_dispatch}; "
                f"cycles with more than one host transfer: {over} "
                f"({batcher.host_transfers} transfers, "
                f"{batcher.summary_transfers} summaries, "
                f"{batcher.gang_cycles} gang cycles)")
    single_mb = (fleet or {}).get("bf16", {}).get("single_peak_mib")
    print(f"shards memory: the 4 x 8 plane's KV cache {cache_mb:.3f} MiB, "
          f"peak above the params {plane_mb:.3f} MiB (one 8-slot replica "
          f"{'not measured' if single_mb is None else f'{single_mb:.3f}'} "
          f"MiB in the fleet phase)", flush=True)
    out["cycles"] = {"cycles": cycles, "busy_cycles": busy_cycles,
                     "host_transfers": batcher.host_transfers,
                     "overlapped_settles": batcher.overlapped_settles,
                     "block_settles": batcher.block_settles,
                     "plane_peak_mib": plane_mb, "cache_mib": cache_mb,
                     "single_peak_mib": single_mb}
    del plane, batcher

    # (c) f32, S = 4: the staggered requests, a few at a time
    inputs = stagger["inputs"]
    requests, want = inputs["requests"], inputs["want"]
    f32 = ShardedBatcher(inputs["params"], inputs["config"], shards=4,
                         shard_slots=8, prompt_len=512, generate_tokens=32,
                         decode_block=8, device="cuda")
    waiting, got, cycle = list(enumerate(requests)), {}, 0
    while (waiting or f32.active) and cycle < 5000:
        free = len(f32.free_slots)
        if waiting and free and cycle % 2 == 0:
            take = min(free, 3)
            f32.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
        for i, tokens in f32.step():
            got[i] = tokens
        cycle += 1
    ties = stagger["near_ties"]
    bad = [i for i, tokens in got.items()
           if not np.array_equal(tokens[:ties[i] or 32],
                                 want[i][:ties[i] or 32])]
    smoke.check(len(got) == 24 and not bad,
                f"shards f32 S=4 staggered: {len(got)} of 24 in {cycle} "
                f"cycles, {f32.insert_dispatches} inserts, "
                f"{f32.gang_cycles} gang cycles; equal to generate alone up "
                f"to the first near-tie: mismatched {bad}")
    out["f32_staggered"] = {"cycles": cycle, "mismatched": bad}
    del f32

    # (d) the chaos episode under the control loop, bf16 then f32
    out["chaos"] = {}
    for label in ("bf16", "f32"):
        if label == "f32":
            params, config = inputs["params"], inputs["config"]
        zero_counts(flash)
        run = chaos_episode(torch, flash, params, config)
        torch.cuda.synchronize()
        run["launches"] = counts(flash)
        out["chaos"][label] = check_chaos(torch, flash, smoke, label, run,
                                          params, config, single)
    del params

    # (e) warm rates, one after another: one block-8 worker, the plane,
    # the 3-replica fleet; then the plane's binary under the profiler
    rates = {}
    for name, argv in (
            ("single-b8", [*GENERATE_ARGS, "--continuous", "--decode-block",
                           "8"]),
            ("shards-4", SHARDS_ARGS),
            ("fleet-3", [*GENERATE_ARGS, "--continuous", "--decode-block",
                         "8", "--fleet-max-replicas", "3"])):
        summary = worker([*demo64(argv), "--device", "cuda"])
        rates[name] = {k: summary.get(k) for k in (
            "msgs_per_s", "tokens_per_s", "ttft_mean_s", "elapsed_s",
            "overlapped_settles", "block_settles")}
        ttft = summary.get("ttft_mean_s")
        print(f"warm {name} --demo 64: {summary['msgs_per_s']:.3f} msgs/s, "
              f"{summary['tokens_per_s']:.3f} generated tokens/s, mean TTFT "
              f"{'none' if ttft is None else f'{ttft * 1e3:.3f} ms'}, "
              f"{summary['elapsed_s']:.3f} s", flush=True)
    out["rates"] = rates
    out["profile"] = plane_profile(torch, worker)
    return out


def chaos_episode(torch, flash, params, config) -> dict:
    """``ShardedWorkerPool.serving(min=1, max=4)`` over 4 shards of 8 slots
    under the binary's control loop (poll 0.1 s, up at 16 messages, down at
    8, cooldowns 0.2 / 0.4 s), two cycles a poll on a ``FakeClock``; the
    traffic arrives over the first cycles, and a fault plan poisons shard
    1's logits, wedges shard 2 and corrupts shard 3's device mask.  Runs
    until every request is answered, no shard is quarantined or probing
    and the plane is back at min."""
    from kube_sqs_autoscaler_tpu_torch.core import (
        ControlLoop, FakeClock, LoopConfig, PolicyConfig,
    )
    from kube_sqs_autoscaler_tpu_torch.fleet import (
        PROBING, QUARANTINED, FleetDriver, ShardedWorkerPool,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics import QueueMetricSource
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    clock = FakeClock()
    queue = FakeMessageQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    bodies = demo_bodies(CHAOS_TOTAL, config.vocab_size)
    sent = [queue.send_message(CHAOS_QUEUE, body)
            for body in bodies[:CHAOS_FIRST]]
    waiting = bodies[CHAOS_FIRST:]
    service_config = ServiceConfig(
        queue_url=CHAOS_QUEUE, batch_size=8, seq_len=512, generate_tokens=32,
        decode_block=8, result_queue_url=CHAOS_RESULTS, shards=4)
    pool = ShardedWorkerPool.serving(
        queue, params, config, service_config, result_queue=results, min=1,
        max=4, clock=clock, now_fn=clock.now,
        probe_after_cycles=CHAOS_PROBE_AFTER, device="cuda")
    loop = ControlLoop(
        pool,
        QueueMetricSource(queue, CHAOS_QUEUE, ("ApproximateNumberOfMessages",)),
        LoopConfig(poll_interval=0.1, policy=PolicyConfig(
            scale_up_messages=2 * 8, scale_down_messages=8,
            scale_up_cooldown=0.2, scale_down_cooldown=0.4)),
        clock=clock)
    faults = FleetFaultPlan(shard_poisons=(CHAOS_POISON,),
                            shard_wedges=(CHAOS_WEDGE,),
                            shard_mask_corruptions=(CHAOS_MASK,))

    class Arrivals:
        """The plan, after this cycle's arrivals."""

        def apply(self, cycle, target):
            for _ in range(min(CHAOS_PER_CYCLE, len(waiting))):
                sent.append(queue.send_message(CHAOS_QUEUE, waiting.pop(0)))
            faults.apply(cycle, target)

    driver = FleetDriver(pool, loop, cycle_dt=0.05, fault_plan=Arrivals())
    start = time.perf_counter()
    with recorded_shapes(flash) as shapes:
        stats = driver.run(max_cycles=3000, until=lambda: (
            len(sent) == CHAOS_TOTAL and pool.processed >= CHAOS_TOTAL
            and pool.idle and pool.replicas == pool.min
            and not any(st in (QUARANTINED, PROBING)
                        for st in pool.shard_states)))
    return {"pool": pool, "stats": stats, "sent": sent, "queue": queue,
            "bodies": dict(zip(sent, bodies)), "shapes": shapes,
            "replies": drain_raw(results, CHAOS_RESULTS),
            "wall_s": time.perf_counter() - start}


def check_chaos(torch, flash, smoke: Smoke, label: str, run: dict, params,
                config, single: dict) -> dict:
    """The chaos episode's gates: exactly once, one quarantine of each
    cause, rows evacuated through a resume insert at [M, 8, 544, 64],
    every quarantined shard probed and readmitted, 4 x inserts launches;
    in f32 each reply against ``generate`` up to the first near-tie."""
    from kube_sqs_autoscaler_tpu_torch.workloads import decode

    pool, stats, sent = run["pool"], run["stats"], run["sent"]
    batcher = pool.worker.batcher
    duplicates = sum(len(b) - 1 for b in run["replies"].values())
    attrs = run["queue"].get_queue_attributes(CHAOS_QUEUE, ())
    smoke.check(sorted(run["replies"]) == sorted(sent)
                and len(sent) == CHAOS_TOTAL and duplicates == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                f"chaos {label}: {len(run['replies'])} of {len(sent)} "
                f"requests answered, {duplicates} duplicates "
                f"({pool.duplicates_suppressed} suppressed, "
                f"{pool.released_total} released to the queue), queue "
                f"{attrs}, {stats['cycles']} cycles, trajectory "
                f"{stats['replica_trajectory']}")
    quarantines = [e.args for e in pool.events
                   if e.name == "shard-quarantine"]
    causes = sorted(q["cause"] for q in quarantines)
    smoke.check(causes == ["mask-mismatch", "no-progress", "poisoned-logits"],
                f"chaos {label}: one quarantine of each cause: {quarantines}")
    resumes = [s for s in run["shapes"] if s[2] == RESUME_SEQ]
    smoke.check(pool.rows_evacuated_total > 0 and resumes
                and all(s[1:] == (8, RESUME_SEQ, 64) for s in resumes),
                f"chaos {label}: {pool.rows_evacuated_total} rows evacuated; "
                f"resume-insert flash_fwd launches at {sorted(set(resumes))} "
                f"(want [M, 8, {RESUME_SEQ}, 64])")
    order = [(e.name, e.args.get("shard")) for e in pool.events]
    unhealed = [q["shard"] for q in quarantines
                if ("shard-probe", q["shard"]) not in order
                or ("shard-readmit", q["shard"]) not in order]
    smoke.check(not unhealed
                and pool.readmitted_total == len(quarantines) == 3,
                f"chaos {label}: every quarantined shard probed and "
                f"readmitted ({pool.readmitted_total} readmitted; not healed: "
                f"{unhealed}); final states {pool.shard_states}")
    launched = run["launches"]
    smoke.check(launched["flash_fwd"] == 4 * batcher.insert_dispatches
                and launched["flash_fwd_lse"] == 0,
                f"chaos {label}: flash_fwd launches {launched['flash_fwd']} "
                f"= 4 x {batcher.insert_dispatches} inserts, lse "
                f"{launched['flash_fwd_lse']}")
    summary = {"cycles": stats["cycles"], "ticks": stats["ticks"],
               "trajectory": stats["replica_trajectory"],
               "quarantines": quarantines,
               "evacuated": pool.rows_evacuated_total,
               "released": pool.released_total,
               "readmitted": pool.readmitted_total,
               "resume_shapes": sorted(set(resumes)),
               "inserts": batcher.insert_dispatches,
               "gang_cycles": batcher.gang_cycles,
               "launches": launched["flash_fwd"], "wall_s": run["wall_s"]}
    if label == "bf16":
        same = sum(bodies[0] == single.get(rid)
                   for rid, bodies in run["replies"].items())
        print(f"chaos bf16: {same} of the 64 requests the single worker "
              f"also served have byte-identical replies (not gated); "
              f"events {[e.name for e in pool.events]}; "
              f"{run['wall_s']:.3f} s", flush=True)
        return {**summary, "same_as_single": same}
    # f32: batches of 16 prompts of 512 tokens through generate, each row
    # against its reply up to the first near-tie
    bad, ties = [], {}
    rids = list(run["bodies"])
    with torch.inference_mode():
        for at in range(0, len(rids), 16):
            chunk = rids[at:at + 16]
            prompts = torch.tensor([json.loads(run["bodies"][r])
                                    for r in chunk], device="cuda")
            want = decode.generate(params, prompts, 32, config,
                                   attention_fn=flash.flash_attention)
            for rid, prompt, tokens in zip(chunk, prompts, want):
                margins = greedy_margins(torch, params, config, prompt,
                                         tokens)
                low = np.flatnonzero(margins < MARGIN)
                upto = int(low[0]) if low.size else 32
                if low.size:
                    ties[rid] = upto
                got = json.loads(run["replies"].get(rid, ["{}"])[0])
                if got.get("tokens", [])[:upto] != tokens.cpu().tolist()[:upto]:
                    bad.append(rid)
    smoke.check(not bad, f"chaos f32: {len(rids) - len(bad)} of {len(rids)} "
                f"replies equal generate up to the first near-tie (margin < "
                f"{MARGIN:g}); mismatched {bad}; near-ties {ties}")
    return {**summary, "mismatched": bad, "near_ties": ties}


def plane_profile(torch, worker, argv=SHARDS_ARGS, label="shards") -> dict:
    """``torch.profiler`` (device activity only) over the binary's
    ``--demo 64 --shards 4`` drain (``argv``): the busy share, and the
    share of block settles that found the next block still running."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = worker([*demo64(argv), "--device", "cuda"])
        torch.cuda.synchronize()
    kernels, copies = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    copy_ms = sum(ms for ms, _, _ in copies)
    wall_ms = summary["elapsed_s"] * 1e3
    flash_ms = sum(ms for ms, _, key in kernels if "flash_fwd" in key)
    overlap = summary["overlapped_settles"] / max(1, summary["block_settles"])
    print(f"profile {label} binary --demo 64 --shards 4 (profiler on): wall "
          f"{wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), flash_fwd {flash_ms:.3f} ms, "
          f"copies {copy_ms:.3f} ms; {summary['overlapped_settles']} of "
          f"{summary['block_settles']} block settles found the next block "
          f"still running ({100 * overlap:.1f}%)", flush=True)
    for ms, count, key in kernels[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share":
            busy_ms / wall_ms, "flash_ms": flash_ms, "copy_ms": copy_ms,
            "overlap_share": overlap,
            "top": [(ms, count, key[:90]) for ms, count, key in kernels[:8]]}


def llama_phase(torch, flash, smoke: Smoke) -> dict:
    """The llama family (``--family llama``: the built-in llama, bf16,
    seeded weights) through every serving path at the generate cell's
    shape: (a) the binary's ``--demo 64`` through the batch worker and
    ``--continuous`` at decode blocks 1 and 8, whose replies must be
    identical, with ``n_layers x inserts`` forward launches and no lse
    launch; (b) the block-8 worker cycle by cycle (at most one decode
    dispatch a cycle) and its KV cache; (c) a one-shard plane whose replies
    must equal the block-8 worker's; (d) the binary's ``--shards 4`` and
    ``--fleet-max-replicas 3``; (e) f32 staggered prompts through the
    batcher against ``llama_generate`` alone; (f) an f32 windowed model:
    the kernel prefill against dense, the rolling generate against the
    full cache; (g) warm rates beside the GPT's, one after another."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    out = {"launches": {}}
    replies = {}
    modes = (("generate", LLAMA_ARGS),
             ("continuous-b1", [*LLAMA_ARGS, "--continuous",
                                "--decode-block", "1"]),
             ("continuous-b8", [*LLAMA_ARGS, "--continuous",
                                "--decode-block", "8"]))
    for mode, args in modes:
        zero_counts(flash)
        summary = worker([*demo64(args), "--device", "cuda"])
        torch.cuda.synchronize()
        launched = counts(flash)
        replies[mode] = {rid: json.dumps(body) for rid, body in
                         summary["replies"].items()}
        attrs = summary["queue_attributes"]
        smoke.check(summary["processed"] == 64 and len(replies[mode]) == 64
                    and summary["duplicate_replies"] == 0
                    and attrs["ApproximateNumberOfMessages"] == "0"
                    and attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
                    and all(len(r.get("tokens", ())) == 32
                            and all(0 <= t < 8192 for t in r["tokens"])
                            for r in summary["replies"].values()),
                    f"llama {mode}: processed {summary['processed']} of 64, "
                    f"{len(replies[mode])} replies of 32 tokens in the "
                    f"vocabulary, {summary['duplicate_replies']} duplicates, "
                    f"queue {attrs}")
        # the batch worker prefills once a batch of 8, the engine once an
        # insert of 8: 8 prompt passes of 4 layers either way
        passes = (summary["insert_dispatches"] if mode != "generate"
                  else 64 // 8)
        smoke.check(passes == 8
                    and launched["flash_fwd"] == LLAMA_LAYERS * passes
                    and launched["flash_fwd_lse"] == 0,
                    f"llama {mode}: flash_fwd launches {launched['flash_fwd']}"
                    f" = {LLAMA_LAYERS} layers x {passes} prompt passes, lse "
                    f"{launched['flash_fwd_lse']}")
        out["launches"][f"serve-llama-{mode}"] = launched["flash_fwd"]
        print(f"llama {mode}: launches {launched}, inserts "
              f"{summary['insert_dispatches']}, decode dispatches "
              f"{summary['decode_dispatches']}, host transfers "
              f"{summary['host_transfers']}", flush=True)
    single = replies["continuous-b8"]
    for mode in ("continuous-b1", "continuous-b8"):
        same = sum(replies[mode].get(r) == b
                   for r, b in replies["generate"].items())
        smoke.check(same == 64, f"llama {mode}: {same} of 64 replies "
                    "byte-identical to the batch worker's (bf16, greedy)")

    # (b) block 8 cycle by cycle, and the compact cache
    cycles = block_cycles_phase(torch, smoke, LLAMA_ARGS, "llama block 8")
    smoke.check(cycles["cache_mib"] == LLAMA_CACHE_MIB,
                f"llama KV cache for 8 slots: {cycles['cache_mib']:.3f} MiB "
                f"(want {LLAMA_CACHE_MIB:.3f}: 2 kv heads where the GPT's "
                f"8 hold 34.000)")
    out["cycles"] = cycles

    # (c) a one-shard plane against the block-8 worker
    config, params, service_config = demo_setup(torch, LLAMA_ARGS, 8)
    results = FakeMessageQueue()
    _, one = plane_worker(torch, params, config, service_config, 1,
                          result_queue=results, sharded=True,
                          family="llama")
    zero_counts(flash)
    one.drain(total=64)
    torch.cuda.synchronize()
    launched = counts(flash)
    plane_replies = {rid: bodies[0] for rid, bodies in
                     drain_raw(results, "demo://replies").items()}
    inserts = one.batcher.insert_dispatches
    same = sum(plane_replies.get(r) == b for r, b in single.items())
    smoke.check(same == 64 and one.batcher.family == "llama"
                and launched["flash_fwd"] == LLAMA_LAYERS * inserts
                and launched["flash_fwd_lse"] == 0,
                f"llama S=1 plane bf16 block 8: {same} of 64 replies "
                f"byte-identical to the block-8 worker's; flash_fwd launches "
                f"{launched['flash_fwd']} = {LLAMA_LAYERS} x {inserts} "
                f"inserts, lse {launched['flash_fwd_lse']}")
    out["launches"]["serve-llama-s1"] = launched["flash_fwd"]
    del one

    # (d) the binary's --shards 4 and --fleet-max-replicas 3
    for name, extra in (("shards-4", ["--shards", "4"]),
                        ("fleet-3", ["--fleet-max-replicas", "3"])):
        zero_counts(flash)
        summary = worker([*demo64(LLAMA_ARGS), "--continuous",
                          "--decode-block", "8", *extra, "--device", "cuda"])
        torch.cuda.synchronize()
        launched = counts(flash)
        inserts = summary["insert_dispatches"]
        smoke.check(summary["processed"] == 64
                    and len(summary["replies"]) == 64
                    and summary["duplicate_replies"] == 0
                    and launched["flash_fwd"] == LLAMA_LAYERS * inserts
                    and launched["flash_fwd_lse"] == 0,
                    f"llama binary {name}: processed {summary['processed']} "
                    f"of 64, {len(summary['replies'])} replies, "
                    f"{summary['duplicate_replies']} duplicates; flash_fwd "
                    f"launches {launched['flash_fwd']} = {LLAMA_LAYERS} x "
                    f"{inserts} inserts, lse {launched['flash_fwd_lse']}")
        same = sum(json.dumps(body) == single.get(rid)
                   for rid, body in summary["replies"].items())
        print(f"llama binary {name}: {same} of 64 replies byte-identical to "
              f"the single block-8 worker's (counted, not gated)", flush=True)
        out["launches"][f"serve-llama-{name}"] = launched["flash_fwd"]
        out[name] = {"same_as_single": same, "inserts": inserts}
    del params

    out["f32"] = llama_f32_checks(torch, flash, smoke)
    out["rates"] = llama_rates(torch, worker)
    out["ops_per_step"] = ops_per_decode_step(torch)
    out["profile"] = plane_profile(
        torch, worker, [*SHARDS_ARGS, "--family", "llama"], "llama shards")
    return out


def ops_per_decode_step(torch) -> dict:
    """The PyTorch operators one decode step of 8 rows dispatches (each a
    kernel launch or a view) for the built-in GPT and llama: the host work
    a decode step costs when serving is launch-bound."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    class Counter(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    out = {}
    for family in ("gpt", "llama"):
        config, params = binary.builtin_model(family, 512, 32, "cuda")
        model = family_of(config)
        ids = torch.zeros((8, 512), dtype=torch.long, device="cuda")
        with torch.inference_mode():
            _, cache = model.full.prefill(params, ids, config)
            with Counter() as counter:
                model.full.decode_step(params, cache, ids[:, 0], config)
        out[family] = counter.ops
    print(f"operators a decode step of 8 rows dispatches: GPT {out['gpt']}, "
          f"llama {out['llama']}", flush=True)
    return out


def llama_f32_checks(torch, flash, smoke: Smoke) -> dict:
    """Parts (e) and (f) of :func:`llama_phase`, in f32 at the built-in
    llama's width."""
    from kube_sqs_autoscaler_tpu_torch.workloads import llama
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        builtin_llama_config,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )

    config = dataclasses.replace(builtin_llama_config(512, 32),
                                 dtype=torch.float32)
    params = llama.init_llama_params(config, torch.Generator().manual_seed(0),
                                     "cuda")
    rng = np.random.default_rng(5)
    lengths = np.linspace(7, 512, 24).round().astype(int)
    requests = [rng.integers(0, config.vocab_size, n) for n in lengths]
    want, near_tie = [], []
    with torch.inference_mode():
        for ids in requests:
            prompt = torch.from_numpy(ids).cuda()
            tokens = llama.llama_generate(
                params, prompt[None], 32, config,
                prompt_attention=llama.llama_attention_fn_for(
                    config, len(ids), "cuda"))[0]
            margins = greedy_margins(torch, params, config, prompt, tokens,
                                     llama.llama_forward)
            low = np.flatnonzero(margins < MARGIN)
            want.append(tokens.cpu().numpy())
            near_tie.append(int(low[0]) if low.size else None)
    out = {}
    for block in (1, 8):
        batcher = ContinuousBatcher(params, config, 8, 512, 32,
                                    family="llama", decode_block=block,
                                    device="cuda")
        before = flash.kernel_launches
        got, cycle = staggered_drive(batcher, requests)
        launched = flash.kernel_launches - before
        bad = [i for i, tokens in got.items()
               if not np.array_equal(tokens[:near_tie[i] or 32],
                                     want[i][:near_tie[i] or 32])]
        ties = {i: p for i, p in enumerate(near_tie) if p is not None}
        smoke.check(
            len(got) == 24 and not bad
            and launched == LLAMA_LAYERS * batcher.insert_dispatches,
            f"llama f32 staggered block {block}: {len(got)} of 24 requests "
            f"in {cycle} cycles and {batcher.insert_dispatches} inserts "
            f"({launched} flash_fwd launches); tokens equal to llama_generate "
            f"alone up to the first near-tie (margin < {MARGIN:g}): "
            f"mismatched {bad}; near-ties (request: position) {ties}")
        out[f"staggered-b{block}"] = {"cycles": cycle, "mismatched": bad,
                                      "near_ties": ties}
    del params

    # the sliding window: the kernel's windowed GQA prefill against dense,
    # and the window-sized ring against the full cache
    windowed = dataclasses.replace(config, sliding_window=128)
    params = llama.init_llama_params(windowed,
                                     torch.Generator().manual_seed(1), "cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    ids = torch.randint(0, config.vocab_size, (4, 512), generator=g,
                        device="cuda")
    row_lengths = torch.tensor([512, 400, 200, 129], device="cuda")
    pick = llama.llama_attention_fn_for(windowed, 512, "cuda")
    with torch.inference_mode():
        before = flash.kernel_launches
        got, _ = llama.llama_prefill(params, ids, windowed, pick,
                                     lengths=row_lengths)
        launched = flash.kernel_launches - before
        dense, _ = llama.llama_prefill(params, ids, windowed,
                                       lengths=row_lengths)
        full = llama.llama_generate(params, ids, 32, windowed,
                                    prompt_attention=pick,
                                    lengths=row_lengths)
        rolling = llama.llama_generate(params, ids, 32, windowed,
                                       prompt_attention=pick,
                                       lengths=row_lengths, rolling=True)
    err = (got - dense).abs().max().item()
    smoke.check(err <= 1e-4 and launched == LLAMA_LAYERS,
                f"llama f32 window 128, 512-token prompts: kernel prefill vs "
                f"dense max|d|={err:.3e} tol=1e-4 ({launched} windowed GQA "
                f"launches)")
    same = bool(torch.equal(full, rolling))
    smoke.check(same, f"llama f32 window 128: the rolling-cache generate's "
                f"{rolling.numel()} tokens equal the full cache's")
    out["window"] = {"prefill_err": err, "rolling_equal": same}
    return out


def llama_rates(torch, worker) -> dict:
    """Warm ``--demo 64`` rates of the GPT and the llama one after the
    other, for the batch worker, block 8 and ``--shards 4``."""
    rates = {}
    for name, extra in (("batch", []),
                        ("block-8", ["--continuous", "--decode-block", "8"]),
                        ("shards-4", ["--continuous", "--decode-block", "8",
                                      "--shards", "4"])):
        for family in ("gpt", "llama"):
            summary = worker([*demo64(GENERATE_ARGS), *extra, "--family",
                              family, "--device", "cuda"])
            ttft = summary.get("ttft_mean_s") or summary["cycle"]["mean_s"]
            rates[f"{family}-{name}"] = {
                "msgs_per_s": summary["msgs_per_s"],
                "tokens_per_s": summary["tokens_per_s"],
                "ttft_mean_s": ttft, "elapsed_s": summary["elapsed_s"]}
            print(f"warm {family} {name} --demo 64: "
                  f"{summary['msgs_per_s']:.3f} msgs/s, "
                  f"{summary['tokens_per_s']:.3f} generated tokens/s, mean "
                  f"TTFT {ttft * 1e3:.3f} ms", flush=True)
    return rates


def odd_head_dim_phase(torch, flash, smoke: Smoke) -> dict:
    """A head dim the kernels do not take (D = 16): the trainer runs it
    through dense attention with no kernel launch, and the kernel wrapper
    called directly refuses it."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    argv = ["--d-model", "64", "--n-heads", "4", "--n-layers", "2",
            "--d-ff", "128", "--vocab-size", "256", "--seq-len", "64",
            "--batch-size", "4", "--steps", "5", "--log-every", "1",
            "--overfit", "--device", "cuda"]
    zero_counts(flash)
    summary = trainer.main(argv)
    torch.cuda.synchronize()
    launched = counts(flash)
    losses = summary["losses"]
    smoke.check(len(losses) == 5 and all(map(math.isfinite, losses))
                and losses[-1] < losses[0] and not any(launched.values()),
                f"odd head dim: trainer --d-model 64 --n-heads 4 (D=16), 5 "
                f"steps, losses {[round(x, 4) for x in losses]}, launches "
                f"{launched} (want all 0: dense attention)")
    q = torch.randn(1, 4, 64, 16, device="cuda", dtype=torch.bfloat16)
    try:
        flash.flash_attention(q, q, q)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    smoke.check(bool(refused) and not any(counts(flash).values()),
                f"odd head dim: flash_attention at D=16 raises ValueError "
                f"({refused[:120]}) before any launch")
    return {"losses": losses, "launches": launched}


# ---------------------------------------------------------------------------
# int8 weights, the int8 KV cache, the chunk decoder and the shared prefix
# ---------------------------------------------------------------------------

INT8_VARIANTS = (("int8-weights", ["--quantize", "int8"]),
                 ("int8-kv", ["--quantize-kv"]),
                 ("int8-both", ["--quantize", "int8", "--quantize-kv"]))
# the built-in models' per-layer matmul parameters (4 layers: the GPT's
# wqkv, wo, w_up, w_down; the llama's wq, wkv, wo, w_gate_up, w_down), and
# their fp32 per-output-channel scales (4 x 4608 channels in both)
INT8_MATMUL_PARAMS = {"gpt": 12_582_912, "llama": 11_272_192}
INT8_SCALE_BYTES = 4 * 4608 * 4
# 8 slots x 4 layers x (k, v) x H_kv x 544 positions x (64 codes + a 4-byte
# scale): H_kv = 8 for the GPT, 2 for the llama; bf16 holds 34.000, 8.500
INT8_CACHE_MIB = {"gpt": 18.0625, "llama": 4.515625}
BF16_CACHE_MIB = {"gpt": 34.0, "llama": LLAMA_CACHE_MIB}
# a shared prefix whose length is no multiple of the kernel's tiles
PREFIX_LEN = 37
PREFIX_IDS = [(97 * i + 13) % 8192 for i in range(PREFIX_LEN)]
PREFIX_ARGS = ["--prefix-ids", ",".join(map(str, PREFIX_IDS))]
ENGINE_MODES = (("generate", []),
                ("continuous-b1", ["--continuous", "--decode-block", "1"]),
                ("continuous-b8", ["--continuous", "--decode-block", "8"]))


class LogLines(logging.Handler):
    """The worker binary's log lines, for the phases that read them."""

    def __init__(self) -> None:
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("worker").addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        logging.getLogger("worker").removeHandler(self)


def run_binary(torch, flash, worker, args: list[str]):
    """One ``--demo 64`` run of the worker binary on the card: (summary,
    launches, the run's own peak memory bytes, its log lines).  The launch
    counts and the memory peak are reset just before and read just after;
    the peak is counted above what was still allocated when the run
    began (the earlier phases' tensors, collected first)."""
    zero_counts(flash)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with LogLines() as logs:
        summary = worker([*demo64(args), "--device", "cuda"])
    torch.cuda.synchronize()
    return (summary, counts(flash), torch.cuda.max_memory_allocated() - base,
            logs.lines)


def replies_of(summary) -> dict:
    return {rid: json.dumps(body) for rid, body in
            summary["replies"].items()}


def check_served(smoke, label, summary, eos_id=None) -> None:
    """64 of 64 answered once and deleted, each reply 32 tokens in the
    vocabulary (with ``eos_id``: at most 32, cut before the eos)."""
    attrs = summary["queue_attributes"]
    smoke.check(summary["processed"] == 64
                and len(summary["replies"]) == 64
                and summary["duplicate_replies"] == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
                and all((len(r.get("tokens", ())) == 32 if eos_id is None
                         else len(r.get("tokens", ())) <= 32
                         and eos_id not in r["tokens"])
                        and all(0 <= t < 8192 for t in r["tokens"])
                        for r in summary["replies"].values()),
                f"{label}: processed {summary['processed']} of 64, "
                f"{len(summary['replies'])} replies of "
                f"{'32' if eos_id is None else 'at most 32'} tokens in the "
                f"vocabulary, {summary['duplicate_replies']} duplicates, "
                f"queue {attrs}")


def int8_codes_and_bytes(torch, smoke: Smoke) -> dict:
    """Codes on the card equal to the CPU's, ``@`` falling through to the
    quantized weight, and the 8-slot caches' bytes, for both families."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.quantize import (
        QuantizedTensor, param_leaves, quantize_params,
    )

    out = {}
    for family in ("gpt", "llama"):
        config, params = binary.builtin_model(family, 512, 32, "cuda")
        on_card = quantize_params(params, family)
        on_host = quantize_params(
            {**{k: v.cpu() for k, v in params.items() if k != "layers"},
             "layers": [{k: v.cpu() for k, v in layer.items()}
                        for layer in params["layers"]]}, family)
        pairs = list(zip(param_leaves(on_card), param_leaves(on_host)))
        same = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                   for a, b in pairs)
        weight = on_card["layers"][0]["wo"]
        x = torch.randn(3, config.d_model, device="cuda",
                        dtype=config.dtype)
        through = (isinstance(weight, QuantizedTensor)
                   and torch.equal(x @ weight, x @ weight.dequantize()))
        smoke.check(same and through,
                    f"int8 {family}: quantize_params on the card gives codes "
                    f"and scales byte-equal to the CPU's ({len(pairs)} "
                    f"tensors); h @ QuantizedTensor falls through to its "
                    f"__rmatmul__ on torch {torch.__version__}")
        cache_mib = {}
        for layout, quantized in (("bf16", False), ("int8", True)):
            batcher = ContinuousBatcher(params, config, 8, 512, 32,
                                        family=family, quantized_kv=quantized,
                                        device="cuda")
            cache_mib[layout] = sum(
                t.numel() * t.element_size()
                for t in flat_params(batcher.cache["layers"])) / 2 ** 20
            del batcher
        smoke.check(cache_mib["int8"] == INT8_CACHE_MIB[family]
                    and cache_mib["bf16"] == BF16_CACHE_MIB[family],
                    f"int8 {family} KV cache for 8 slots at max_seq_len 544: "
                    f"{cache_mib['int8']:.4f} MiB (want "
                    f"{INT8_CACHE_MIB[family]:.4f}) against bf16's "
                    f"{cache_mib['bf16']:.4f}")
        out[family] = {"codes_equal": same, "cache_mib": cache_mib}
    return out


def plane_s1_replies(torch, flash, family, flags) -> tuple[dict, int, int]:
    """A one-shard plane (``sharded=True``) at block 8 over the demo
    bodies with ``flags``' weights and cache: (replies, flash launches,
    inserts)."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.quantize import (
        quantize_params,
    )

    config, params, service_config = demo_setup(
        torch, [*GENERATE_ARGS, "--family", family], 8)
    if "--quantize" in flags:
        params = quantize_params(params, family)
    service_config.quantized_kv = "--quantize-kv" in flags
    results = FakeMessageQueue()
    _, one = plane_worker(torch, params, config, service_config, 1,
                          result_queue=results, sharded=True, family=family)
    zero_counts(flash)
    one.drain(total=64)
    torch.cuda.synchronize()
    launched = counts(flash)
    replies = {rid: bodies[0] for rid, bodies in
               drain_raw(results, "demo://replies").items()}
    return replies, launched["flash_fwd"], one.batcher.insert_dispatches


def int8_phase(torch, flash, smoke: Smoke) -> dict:
    """int8 serving at the built-in GPT's and llama's full width in bf16:
    (a) codes on the card equal to the CPU's and the 8-slot caches' bytes;
    (b) the binary's ``--demo 64`` with ``--quantize int8``,
    ``--quantize-kv`` and both, through the batch worker and
    ``--continuous`` at blocks 1 and 8, and a one-shard plane: replies
    identical across the four, ``n_layers x`` prompt passes forward
    launches and no lse, the weight bytes from the binary's log line;
    (c) in f32 with int8 weights and the int8 cache, the staggered
    prompts through the batcher at blocks 1 and 8 and a 4-shard plane
    against the port's own int8 generate, up to the first near-tie; (d)
    warm rates and peak memory of bf16, int8 weights, int8 cache and both
    at block 8 and ``--shards 4``, one after another, and a profiled int8
    plane."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    out = {"launches": {}, "codes": int8_codes_and_bytes(torch, smoke)}
    layers = 4
    for family in ("gpt", "llama"):
        args = [*GENERATE_ARGS, "--family", family]
        for variant, flags in INT8_VARIANTS:
            replies, launched_total = {}, 0
            for mode, extra in ENGINE_MODES:
                label = f"{family} {variant} {mode}"
                summary, launched, _, logs = run_binary(
                    torch, flash, worker, [*args, *flags, *extra])
                check_served(smoke, label, summary)
                passes = (summary["insert_dispatches"] if mode != "generate"
                          else 64 // 8)
                smoke.check(passes == 8
                            and launched["flash_fwd"] == layers * passes
                            and launched["flash_fwd_lse"] == 0,
                            f"{label}: flash_fwd launches "
                            f"{launched['flash_fwd']} = {layers} layers x "
                            f"{passes} prompt passes, lse "
                            f"{launched['flash_fwd_lse']}")
                launched_total += launched["flash_fwd"]
                replies[mode] = replies_of(summary)
                if "--quantize" in flags and mode == "generate":
                    before, after = summary["weight_bytes"]
                    line = [s for s in logs if "Quantized weights" in s]
                    want = 2 * INT8_MATMUL_PARAMS[family]
                    smoke.check(
                        bool(line) and before - after
                        == want - INT8_MATMUL_PARAMS[family]
                        - INT8_SCALE_BYTES,
                        f"int8 {family} weights: {line[:1]} ({before} -> "
                        f"{after} bytes: {INT8_MATMUL_PARAMS[family]} matmul "
                        f"parameters at one byte, {INT8_SCALE_BYTES} bytes "
                        f"of scales)")
                    out[f"{family}-weight-bytes"] = [before, after]
            replies["s1"], s1_launches, inserts = plane_s1_replies(
                torch, flash, family, flags)
            smoke.check(s1_launches == layers * inserts,
                        f"{family} {variant} S=1 plane: flash_fwd launches "
                        f"{s1_launches} = {layers} x {inserts} inserts")
            launched_total += s1_launches
            base = replies["generate"]
            same = {mode: sum(replies[mode].get(r) == b
                              for r, b in base.items())
                    for mode in ("continuous-b1", "continuous-b8", "s1")}
            smoke.check(all(n == 64 for n in same.values()),
                        f"{family} {variant}: replies byte-identical to the "
                        f"batch worker's (bf16, greedy), of 64: {same}")
            out["launches"][f"serve-{family}-{variant}"] = launched_total
    out["f32"] = int8_f32_checks(torch, flash, smoke)
    out["rates"] = int8_rates(torch, flash, worker)
    out["profile"] = plane_profile(
        torch, worker, [*SHARDS_ARGS, "--quantize", "int8", "--quantize-kv"],
        "int8 shards")
    return out


def rollout(torch, start, step, steps: int = 32):
    """Greedy tokens and each one's top-two margin along the port's own
    path (``start() -> (logits, cache)``, ``step(cache, token)``), one
    prompt a call: the loop of ``generate``."""
    logits, cache = start()
    tokens, margins = [], []
    for i in range(steps):
        top = logits.float().topk(2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
        token = logits.argmax(-1)
        tokens.append(token)
        if i < steps - 1:
            logits, cache = step(cache, token)
    return (torch.stack(tokens, dim=1)[0].cpu().numpy(),
            np.stack(margins, axis=1)[0])


def staggered_requests(vocab: int = 8192) -> list:
    rng = np.random.default_rng(5)
    lengths = np.linspace(7, 512, 24).round().astype(int)
    return [rng.integers(0, vocab, n) for n in lengths]


def compare_upto_ties(got: dict, want: list, margins: list) -> tuple:
    """Requests whose tokens differ before their first near-tie, and the
    near-ties (request: position)."""
    bad, ties = [], {}
    for i, tokens in got.items():
        low = np.flatnonzero(margins[i] < MARGIN)
        upto = int(low[0]) if low.size else len(want[i])
        if low.size:
            ties[i] = upto
        if not np.array_equal(np.asarray(tokens)[:upto], want[i][:upto]):
            bad.append(i)
    return bad, ties


def int8_f32_checks(torch, flash, smoke: Smoke) -> dict:
    """Part (c) of :func:`int8_phase`."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        BUILTIN_CONFIGS,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
    from kube_sqs_autoscaler_tpu_torch.workloads.quantize import (
        quantize_params,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
        ShardedBatcher,
    )

    out = {}
    requests = staggered_requests()
    for family in ("gpt", "llama"):
        config = dataclasses.replace(BUILTIN_CONFIGS[family](512, 32),
                                     dtype=torch.float32)
        model = family_of(config)
        params = quantize_params(
            model.init_params(config, torch.Generator().manual_seed(0),
                              "cuda"), family)
        layout = model.layout(quantized_kv=True)
        want, margins = [], []
        with torch.inference_mode():
            for ids in requests:
                prompt = torch.from_numpy(ids).cuda()[None]
                pick = model.attention_fn_for(config, prompt.shape[1], "cuda")
                tokens, margin = rollout(
                    torch,
                    lambda: layout.prefill(params, prompt, config, pick),
                    lambda cache, token: layout.decode_step(
                        params, cache, token, config))
                want.append(tokens)
                margins.append(margin)
            first = torch.from_numpy(requests[0]).cuda()[None]
            generated = model.generate(
                params, first, 32, config,
                model.attention_fn_for(config, first.shape[1], "cuda"),
                quantized_cache=True)[0].cpu().numpy()
        smoke.check(np.array_equal(generated, want[0]),
                    f"int8 {family} f32: the rollout is generate("
                    "quantized_cache=True)'s loop (request 0 equal)")
        engines = (
            ("block-1", lambda: ContinuousBatcher(
                params, config, 8, 512, 32, family=family, quantized_kv=True,
                decode_block=1, device="cuda")),
            ("block-8", lambda: ContinuousBatcher(
                params, config, 8, 512, 32, family=family, quantized_kv=True,
                decode_block=8, device="cuda")),
            ("shards-4", lambda: ShardedBatcher(
                params, config, shards=4, shard_slots=8, prompt_len=512,
                generate_tokens=32, family=family, quantized_kv=True,
                decode_block=8, device="cuda")),
        )
        for name, make in engines:
            batcher = make()
            before = flash.kernel_launches
            got, cycles = staggered_drive(batcher, requests)
            launched = flash.kernel_launches - before
            bad, ties = compare_upto_ties(got, want, margins)
            smoke.check(
                len(got) == 24 and not bad
                and launched == 4 * batcher.insert_dispatches,
                f"int8 {family} f32 {name} (int8 weights and cache): "
                f"{len(got)} of 24 staggered requests in {cycles} cycles, "
                f"{batcher.insert_dispatches} inserts ({launched} flash_fwd "
                f"launches); tokens equal to the port's int8 generate alone "
                f"up to the first near-tie (margin < {MARGIN:g}): mismatched "
                f"{bad}; near-ties (request: position) {ties}")
            out[f"{family}-{name}"] = {"mismatched": bad, "near_ties": ties}
            del batcher
        del params
    return out


def int8_rates(torch, flash, worker) -> dict:
    """Warm ``--demo 64`` rates and peak memory of bf16, int8 weights, the
    int8 cache and both, at block 8 and ``--shards 4``, for both families,
    one run after another."""
    rates = {}
    for family in ("gpt", "llama"):
        for name, extra in (("block-8", ["--continuous", "--decode-block",
                                         "8"]),
                            ("shards-4", ["--continuous", "--decode-block",
                                          "8", "--shards", "4"])):
            for variant, flags in (("bf16", []), *INT8_VARIANTS):
                summary, _, peak, _ = run_binary(
                    torch, flash, worker,
                    [*GENERATE_ARGS, "--family", family, *extra, *flags])
                key = f"{family}-{name}-{variant}"
                rates[key] = {"msgs_per_s": summary["msgs_per_s"],
                              "tokens_per_s": summary["tokens_per_s"],
                              "ttft_mean_s": summary["ttft_mean_s"],
                              "peak_mib": peak / 2 ** 20}
                print(f"warm {key} --demo 64: {summary['msgs_per_s']:.3f} "
                      f"msgs/s, {summary['tokens_per_s']:.3f} generated "
                      f"tokens/s, mean TTFT "
                      f"{summary['ttft_mean_s'] * 1e3:.3f} ms, "
                      f"max_memory_allocated {peak / 2 ** 20:.3f} MiB above "
                      f"the run's start",
                      flush=True)
    return rates


def prefix_phase(torch, flash, smoke: Smoke) -> dict:
    """The shared prefix (``--prefix-ids``, 37 tokens: no multiple of the
    kernel's tiles) at both families' full width: (a) the binary's
    ``--demo 64`` in bf16 through the batch worker, blocks 1 and 8 and
    ``--shards 4``, full-precision and int8 cache: the prefix's
    ``n_layers`` forward launches once at start-up, the suffix inserts
    through the chunk decoder none, no lse; replies counted against the
    batch worker's (bf16 rounding differs across row counts, so counted,
    not gated); (b) in f32 the staggered suffixes through the block-8
    batcher behind the prefix against ``generate`` of prefix and suffix
    joined (full layout) and against the port's own int8 prefix generate
    (int8 layout), up to the first near-tie."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    out = {"launches": {}, "replies_same": {}}
    layers = 4
    modes = (*ENGINE_MODES,
             ("shards-4", ["--continuous", "--decode-block", "8",
                           "--shards", "4"]))
    for family in ("gpt", "llama"):
        for layout, flags in (("full", []), ("int8-kv", ["--quantize-kv"])):
            replies, launched_total = {}, 0
            for mode, extra in modes:
                label = f"prefix {family} {layout} {mode}"
                summary, launched, _, logs = run_binary(
                    torch, flash, worker,
                    [*GENERATE_ARGS, "--family", family, *PREFIX_ARGS,
                     *flags, *extra])
                check_served(smoke, label, summary)
                prefilled = any(f"{PREFIX_LEN} shared tokens" in s
                                for s in logs)
                smoke.check(prefilled and launched["flash_fwd"] == layers
                            and launched["flash_fwd_lse"] == 0,
                            f"{label}: the prefix prefilled once "
                            f"({prefilled}); flash_fwd launches "
                            f"{launched['flash_fwd']} = {layers} layers x 1 "
                            f"(the suffixes' "
                            f"{summary['insert_dispatches'] or 8} prompt "
                            f"passes run the chunk decoder), lse "
                            f"{launched['flash_fwd_lse']}")
                launched_total += launched["flash_fwd"]
                replies[mode] = replies_of(summary)
            base = replies["generate"]
            same = {mode: sum(replies[mode].get(r) == b
                              for r, b in base.items())
                    for mode in replies if mode != "generate"}
            print(f"prefix {family} {layout}: replies byte-identical to the "
                  f"batch worker's, of 64 (counted, not gated): {same}",
                  flush=True)
            out["replies_same"][f"{family}-{layout}"] = same
            out["launches"][f"serve-prefix-{family}-{layout}"] = \
                launched_total
    out["f32"] = prefix_f32_checks(torch, flash, smoke)
    return out


def prefix_f32_checks(torch, flash, smoke: Smoke) -> dict:
    """Part (b) of :func:`prefix_phase`."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        BUILTIN_CONFIGS,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    out = {}
    requests = staggered_requests()
    prefix = torch.tensor(PREFIX_IDS, device="cuda")
    for family in ("gpt", "llama"):
        config = dataclasses.replace(
            BUILTIN_CONFIGS[family](512, 32, PREFIX_LEN), dtype=torch.float32)
        model = family_of(config)
        params = model.init_params(config, torch.Generator().manual_seed(0),
                                   "cuda")
        for layout_name, quantized in (("full", False), ("int8-kv", True)):
            layout = model.layout(quantized)
            with torch.inference_mode():
                before = flash.kernel_launches
                prefix_cache = layout.prefill_prefix(
                    params, prefix, config,
                    model.attention_fn_for(config, PREFIX_LEN, "cuda"))
                prefix_launches = flash.kernel_launches - before
                want, margins = [], []
                for ids in requests:
                    suffix = torch.from_numpy(ids).cuda()[None]
                    if quantized:  # the port's own int8 prefix path
                        def start(suffix=suffix):
                            return layout.prefill_with_prefix(
                                params, prefix_cache, suffix, config)
                    else:  # prefix and suffix prefilled as one prompt
                        joined = torch.cat([prefix[None], suffix], dim=1)

                        def start(joined=joined):
                            return layout.prefill(
                                params, joined, config,
                                model.attention_fn_for(
                                    config, joined.shape[1], "cuda"))
                    tokens, margin = rollout(
                        torch, start, lambda cache, token: layout.decode_step(
                            params, cache, token, config))
                    want.append(tokens)
                    margins.append(margin)
            batcher = ContinuousBatcher(
                params, config, 8, 512, 32, family=family,
                quantized_kv=quantized, prefix_cache=prefix_cache,
                decode_block=8, device="cuda")
            before = flash.kernel_launches
            got, cycles = staggered_drive(batcher, requests)
            launched = flash.kernel_launches - before
            bad, ties = compare_upto_ties(got, want, margins)
            oracle = ("the int8 prefix generate" if quantized
                      else "generate of prefix + suffix joined")
            smoke.check(
                len(got) == 24 and not bad and launched == 0
                and prefix_launches == 4 and batcher.prefix_len == PREFIX_LEN,
                f"prefix {family} f32 {layout_name} block 8: {len(got)} of 24 "
                f"staggered suffixes behind the {PREFIX_LEN}-token prefix "
                f"({prefix_launches} flash_fwd launches for the prefix, "
                f"{launched} for {batcher.insert_dispatches} suffix "
                f"inserts); tokens equal to {oracle} up to the first "
                f"near-tie (margin < {MARGIN:g}): "
                f"mismatched {bad}; near-ties {ties}")
            out[f"{family}-{layout_name}"] = {"mismatched": bad,
                                              "near_ties": ties}
            del batcher, prefix_cache
        del params
    return out


# -- speculative decoding and beam search -----------------------------------

SPEC_DRAFT = 2  # the self-draft's depth: the first 2 of the 4 layers
SPEC_K = 4  # proposals a round
SPEC_ARGS = ["--speculative-draft-layers", str(SPEC_DRAFT),
             "--speculative-draft-tokens", str(SPEC_K)]
BEAMS = 4
BEAM_ARGS = ["--beams", str(BEAMS)]
SERVE_LAYERS = 4  # the built-in models' depth
MARGINAL_ROWS = 100_000
MARGINAL_VOCAB = 32
MARGINAL_TV = 0.01


def plain_replies(torch, family: str, headroom: int) -> dict:
    """The plain greedy batch worker's ``--demo 64`` replies, with the
    weights of the built-in config whose context is widened by
    ``headroom`` (the speculative binary's 2k: the GPT's position table,
    and so its seeded weights, depend on the context)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    config, params = binary.builtin_model(family, 512, 32, "cuda",
                                          headroom=headroom)
    service_config = ServiceConfig(queue_url="", batch_size=8, seq_len=512,
                                   generate_tokens=32,
                                   result_queue_url="demo://replies")
    summary = binary.run_demo(64, params, config, service_config,
                              torch.device("cuda"))
    return replies_of(summary)


def count_same(replies: dict, base: dict) -> int:
    return sum(replies.get(rid) == body for rid, body in base.items())


def engine_rates(summary) -> dict:
    return {"msgs_per_s": summary["msgs_per_s"],
            "tokens_per_s": summary["tokens_per_s"],
            "ttft_mean_s": summary["ttft_mean_s"]}


def speculative_phase(torch, flash, smoke: Smoke) -> dict:
    """Speculative decoding (``--speculative-draft-layers 2
    --speculative-draft-tokens 4``: the first 2 of 4 layers draft, 4
    proposals a round) at both families' full width: (a) the binary's
    ``--demo 64`` in bf16 through the batch worker (one prefill of the
    target and one of the draft a batch: ``n_layers + draft_layers``
    forward launches, no lse) and ``--continuous`` (one target prefill an
    insert seeds both caches: ``n_layers`` launches an insert); replies
    counted against the plain greedy batch worker's on the same weights;
    the accepted fraction, rounds a request and second rounds dispatched
    ahead (and still running when the first was read); (b) sampled, the
    GPT at ``--temperature 0.8`` in both workers: 64 of 64 answered, every
    token in the vocabulary; (c) the rejection rule on the card:
    ``_accept_and_fixup`` over 10^5 rows of synthetic draft and target
    distributions (V = 32), the emitted marginal within total variation
    0.01 of the warped target; (d) in f32 the staggered prompts through
    the batch ``speculative_generate`` and the slot engine against the
    port's greedy generate, up to the first near-tie; (e) the GPT with
    ``--quantize-kv`` and with the 37-token prefix, each answering 64 of
    64."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    out = {"launches": {}, "replies_same": {}, "stats": {}, "rates": {}}
    for family in ("gpt", "llama"):
        base = plain_replies(torch, family, 2 * SPEC_K)
        total = 0
        for mode, extra in (("generate", []),
                            ("continuous", ["--continuous"])):
            label = f"speculative {family} {mode}"
            summary, launched, _, logs = run_binary(
                torch, flash, worker,
                [*GENERATE_ARGS, "--family", family, *SPEC_ARGS, *extra])
            check_served(smoke, label, summary)
            logged = any(f"{SPEC_DRAFT}-layer early-exit self-draft, "
                         f"{SPEC_K} proposals/round" in s for s in logs)
            if mode == "generate":
                passes, per_pass = 64 // 8, SERVE_LAYERS + SPEC_DRAFT
            else:
                passes, per_pass = summary["insert_dispatches"], SERVE_LAYERS
            smoke.check(
                logged and (mode == "generate" or passes == 64)
                and launched["flash_fwd"] == per_pass * passes
                and launched["flash_fwd_lse"] == 0,
                f"{label}: logged ({logged}); flash_fwd launches "
                f"{launched['flash_fwd']} = {per_pass} x {passes} prompt "
                f"passes, lse {launched['flash_fwd_lse']}")
            total += launched["flash_fwd"]
            same = count_same(replies_of(summary), base)
            print(f"{label}: replies byte-identical to the plain greedy "
                  f"batch worker's on the same weights, of 64 (bf16, counted, "
                  f"not gated): {same}", flush=True)
            out["replies_same"][f"{family}-{mode}"] = same
            if mode == "continuous":
                rounds = summary["spec_rounds"]
                stats = {
                    "accepted_fraction": summary["spec_accepted"]
                    / (SPEC_K * rounds),
                    "rounds_per_request": rounds / 64,
                    "second_rounds": summary["spec_second_rounds"],
                    "second_rounds_running_at_read":
                        summary["spec_overlapped"],
                    "decode_dispatches": summary["decode_dispatches"],
                }
                print(f"{label}: accepted {stats['accepted_fraction']:.4f} "
                      f"of the drafts, {stats['rounds_per_request']:.3f} "
                      f"rounds a request, {stats['second_rounds']} second "
                      f"rounds dispatched ahead of the first's read, "
                      f"{stats['second_rounds_running_at_read']} of them "
                      f"still running at that read", flush=True)
                out["stats"][family] = stats
                out["rates"][f"{family}-speculative"] = engine_rates(summary)
        out["launches"][f"serve-speculative-{family}"] = total
    for mode, extra in (("generate", []), ("continuous", ["--continuous"])):
        summary, launched, _, _ = run_binary(
            torch, flash, worker,
            [*GENERATE_ARGS, *SPEC_ARGS, "--temperature", "0.8", *extra])
        check_served(smoke, f"speculative gpt sampled {mode}", summary)
        out["launches"]["serve-speculative-gpt"] += launched["flash_fwd"]
    out["marginal"] = spec_marginal(torch, smoke)
    out["f32"] = spec_f32_checks(torch, flash, smoke)
    out["launches"]["serve-speculative-gpt"] += compositions(
        torch, flash, smoke, worker, SPEC_ARGS, "speculative")
    return out


def compositions(torch, flash, smoke, worker, mode_args, name) -> int:
    """The GPT's ``--continuous`` with ``mode_args`` over the int8 cache
    and behind the 37-token prefix: 64 of 64 answered, ``n_layers`` forward
    launches an insert (the prefix's once, its suffixes none); returns
    the launches."""
    total = 0
    for layout, flags in (("int8-kv", ["--quantize-kv"]),
                          ("prefix", PREFIX_ARGS)):
        label = f"{name} gpt {layout} continuous"
        summary, launched, _, _ = run_binary(
            torch, flash, worker,
            [*GENERATE_ARGS, *mode_args, *flags, "--continuous"])
        check_served(smoke, label, summary)
        want = (SERVE_LAYERS if layout == "prefix"
                else SERVE_LAYERS * summary["insert_dispatches"])
        smoke.check(summary["insert_dispatches"] == 64
                    and launched["flash_fwd"] == want
                    and launched["flash_fwd_lse"] == 0,
                    f"{label}: {summary['insert_dispatches']} inserts, "
                    f"flash_fwd launches {launched['flash_fwd']} (want {want})"
                    f", lse {launched['flash_fwd_lse']}")
        total += launched["flash_fwd"]
    return total


def spec_marginal(torch, smoke: Smoke) -> dict:
    """The speculative-sampling rule on the card: 10^5 rows of one draft
    proposal (k = 1) from synthetic draft logits, accepted or fixed up
    against synthetic target logits (both warped at temperature 0.8,
    top-k 20): the emitted token's empirical distribution against the
    warped target's softmax, in total variation."""
    from kube_sqs_autoscaler_tpu_torch.workloads import speculative

    generator = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((2, MARGINAL_VOCAB), device="cuda",
                         generator=generator) * 1.5
    draft_w = speculative._warp(logits[0], 0.8, 20, 1.0)
    target_w = speculative._warp(logits[1], 0.8, 20, 1.0)
    rows = MARGINAL_ROWS
    draft = draft_w.expand(rows, 1, MARGINAL_VOCAB)
    target = target_w.expand(rows, 2, MARGINAL_VOCAB)
    drafts = speculative._sample(draft[:, 0], generator)[:, None]
    n, fixup = speculative._accept_and_fixup(generator, drafts, draft,
                                             target)
    emitted = torch.where(n >= 1, drafts[:, 0], fixup)
    empirical = torch.bincount(emitted, minlength=MARGINAL_VOCAB).double()
    empirical /= rows
    expected = torch.softmax(target_w.double(), dim=-1)
    tv = 0.5 * float((empirical - expected).abs().sum())
    accepted = float(n.double().mean())
    smoke.check(tv < MARGINAL_TV,
                f"speculative sampling on the card: {rows} rows, V = "
                f"{MARGINAL_VOCAB}, {accepted:.4f} of the drafts accepted; "
                f"the emitted marginal's total variation from the warped "
                f"target {tv:.5f} (< {MARGINAL_TV})")
    return {"tv": tv, "accepted": accepted}


def f32_model(torch, family: str, headroom: int = 0):
    """``(config, params, family record)`` of the built-in model of
    ``family`` in f32 with its context widened by ``headroom``."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        BUILTIN_CONFIGS,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    config = dataclasses.replace(
        BUILTIN_CONFIGS[family](512, 32, 0, headroom), dtype=torch.float32)
    model = family_of(config)
    return (config, model.init_params(
        config, torch.Generator().manual_seed(0), "cuda"), model)


def padded_batches(torch, requests, rows: int = 8):
    """The requests as ``[rows, 512]`` right-padded batches with their
    lengths, on the card."""
    for start in range(0, len(requests), rows):
        chunk = requests[start:start + rows]
        ids = torch.zeros((len(chunk), 512), dtype=torch.long)
        for i, prompt in enumerate(chunk):
            ids[i, :len(prompt)] = torch.from_numpy(prompt)
        yield start, ids.cuda(), torch.tensor(
            [len(p) for p in chunk], device="cuda")


def spec_f32_checks(torch, flash, smoke: Smoke) -> dict:
    """Part (d) of :func:`speculative_phase`."""
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.speculative import (
        self_draft, speculative_generate,
    )

    out = {}
    requests = staggered_requests()
    for family in ("gpt", "llama"):
        config, params, model = f32_model(torch, family, 2 * SPEC_K)
        layout = model.full
        want, margins = [], []
        with torch.inference_mode():
            for ids in requests:
                prompt = torch.from_numpy(ids).cuda()[None]
                pick = model.attention_fn_for(config, prompt.shape[1], "cuda")
                tokens, margin = rollout(
                    torch,
                    lambda: layout.prefill(params, prompt, config, pick),
                    lambda cache, token: layout.decode_step(
                        params, cache, token, config))
                want.append(tokens)
                margins.append(margin)
            draft_params, draft_config = self_draft(params, config,
                                                    SPEC_DRAFT)
            got, launched, calls = {}, 0, 0
            for start, ids, lengths in padded_batches(torch, requests):
                before = flash.kernel_launches
                tokens = speculative_generate(
                    params, config, draft_params, draft_config, ids, 32,
                    draft_tokens=SPEC_K, lengths=lengths,
                    attention_fn=model.attention_fn_for(config, 512, "cuda"))
                launched += flash.kernel_launches - before
                calls += 1
                for i, row in enumerate(tokens.cpu().numpy()):
                    got[start + i] = row
        bad, ties = compare_upto_ties(got, want, margins)
        smoke.check(
            len(got) == 24 and not bad
            and launched == (SERVE_LAYERS + SPEC_DRAFT) * calls,
            f"speculative {family} f32 batch speculative_generate: 24 "
            f"staggered prompts in {calls} batches ({launched} flash_fwd "
            f"launches); tokens equal to the port's greedy generate alone up "
            f"to the first near-tie (margin < {MARGIN:g}): mismatched {bad}; "
            f"near-ties {ties}")
        batcher = ContinuousBatcher(
            params, config, 8, 512, 32, family=family,
            draft_layers=SPEC_DRAFT, draft_tokens=SPEC_K, device="cuda")
        before = flash.kernel_launches
        slots, cycles = staggered_drive(batcher, requests)
        slot_launches = flash.kernel_launches - before
        slot_bad, slot_ties = compare_upto_ties(slots, want, margins)
        smoke.check(
            len(slots) == 24 and not slot_bad
            and slot_launches == SERVE_LAYERS * batcher.insert_dispatches,
            f"speculative {family} f32 slot engine: {len(slots)} of 24 "
            f"staggered prompts in {cycles} cycles, "
            f"{batcher.insert_dispatches} inserts ({slot_launches} flash_fwd "
            f"launches), {batcher.spec_rounds} rounds accepting "
            f"{batcher.spec_accepted}; tokens equal to the port's greedy "
            f"generate alone up to the first near-tie: mismatched "
            f"{slot_bad}; near-ties {slot_ties}")
        out[family] = {"batch": {"mismatched": bad, "near_ties": ties},
                       "slots": {"mismatched": slot_bad,
                                 "near_ties": slot_ties}}
        del batcher, params
    return out


def eos_token(replies: dict) -> int:
    """A token the demo's greedy replies emit: the commonest one at
    positions 4-12 (so some beams end early and most do not)."""
    counts_ = np.bincount([t for body in replies.values()
                           for t in json.loads(body)["tokens"][4:12]])
    return int(counts_.argmax())


def beam_phase(torch, flash, smoke: Smoke) -> dict:
    """Beam search (``--beams 4``, and with ``--length-penalty 0.6
    --eos-id`` a token the demo emits) at both families' full width: (a)
    the binary's ``--demo 64`` in bf16 through the batch worker (one
    prompt pass a batch: ``n_layers`` forward launches) and
    ``--continuous`` (one an insert), replies counted between the two; (b)
    in f32 the staggered prompts through the beam slot engine against the
    port's batch ``beam_search`` of each prompt alone, up to the first
    step where the standalone search's choice is a near-tie; (c) the GPT
    with ``--quantize-kv`` and with the 37-token prefix; (d) the warm
    rates of plain block-1 ``--continuous``, speculative and beams, and a
    profiled beam drain with the parent gather's share of the device
    time."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    out = {"launches": {}, "replies_same": {}, "rates": {}, "eos": {}}
    for family in ("gpt", "llama"):
        eos = eos_token(plain_replies(torch, family, 0))
        out["eos"][family] = eos
        total = 0
        for variant, flags in (
                ("beams", BEAM_ARGS),
                ("beams-eos-penalty", [*BEAM_ARGS, "--length-penalty", "0.6",
                                       "--eos-id", str(eos)])):
            replies = {}
            for mode, extra in (("generate", []),
                                ("continuous", ["--continuous"])):
                label = f"{variant} {family} {mode}"
                summary, launched, _, logs = run_binary(
                    torch, flash, worker,
                    [*GENERATE_ARGS, "--family", family, *flags, *extra])
                check_served(smoke, label, summary,
                             eos_id=eos if "--eos-id" in flags else None)
                passes = (64 // 8 if mode == "generate"
                          else summary["insert_dispatches"])
                logged = any(f"Beam search: {BEAMS} beams" in s for s in logs)
                smoke.check(
                    logged and (mode == "generate" or passes == 64)
                    and launched["flash_fwd"] == SERVE_LAYERS * passes
                    and launched["flash_fwd_lse"] == 0,
                    f"{label}: logged ({logged}); flash_fwd launches "
                    f"{launched['flash_fwd']} = {SERVE_LAYERS} x {passes} "
                    f"prompt passes, lse {launched['flash_fwd_lse']}")
                total += launched["flash_fwd"]
                replies[mode] = replies_of(summary)
                if mode == "continuous" and variant == "beams":
                    out["rates"][f"{family}-beams"] = engine_rates(summary)
            same = count_same(replies["continuous"], replies["generate"])
            ended = sum(len(json.loads(b)["tokens"]) < 32
                        for b in replies["generate"].values())
            print(f"{variant} {family}: continuous replies byte-identical to "
                  f"the batch worker's, of 64 (bf16, counted, not gated): "
                  f"{same}; replies ended by eos {ended}", flush=True)
            out["replies_same"][f"{family}-{variant}"] = same
        summary, _, _, _ = run_binary(
            torch, flash, worker,
            [*GENERATE_ARGS, "--family", family, "--continuous"])
        out["rates"][f"{family}-plain-b1"] = engine_rates(summary)
        out["launches"][f"serve-beams-{family}"] = total
    out["f32"] = beam_f32_checks(torch, flash, smoke)
    out["launches"]["serve-beams-gpt"] += compositions(
        torch, flash, smoke, worker, BEAM_ARGS, "beams")
    return out


def beam_gaps(torch, params, config, layout, prompt, lengths, pick,
              steps: int = 32, eos_id=None):
    """Each step's selection gap of :func:`beam.beam_search` on one prompt:
    the distance between the ``W``-th and the ``W + 1``-th best of the
    ``W * V`` continuations (the first expansion's too), the place where
    another summation order could pick another beam.  The search's own
    loop, with the ``W + 1``-th candidate read off."""
    from kube_sqs_autoscaler_tpu_torch.workloads import beam

    logits, cache = layout.prefill(params, prompt, config, pick,
                                   lengths=lengths)
    logp = torch.log_softmax(logits.float(), dim=-1)
    top, last = beam.top_k_lowest_first(logp, BEAMS + 1)
    gaps = [float(top[0, BEAMS - 1] - top[0, BEAMS])]
    scores, last = top[:, :BEAMS], last[:, :BEAMS]
    cache = beam.repeat_rows(cache, BEAMS)
    gather = beam.RowGather(cache)
    alive = (last != eos_id if eos_id is not None
             else torch.ones_like(last, dtype=torch.bool))
    for _ in range(steps - 1):
        logits, cache = layout.decode_step(params, cache, last.reshape(-1),
                                           config)
        logp = torch.log_softmax(logits.float(), dim=-1).view(1, BEAMS, -1)
        if eos_id is not None:
            frozen = torch.full_like(logp, float("-inf"))
            frozen[..., eos_id] = 0.0
            logp = torch.where(alive[..., None], logp, frozen)
        total = (scores[..., None] + logp).reshape(1, -1)
        top, _ = beam.top_k_lowest_first(total, BEAMS + 1)
        gaps.append(float(top[0, BEAMS - 1] - top[0, BEAMS]))
        scores, parent, last = beam.expand_beams(logp, scores, alive, None)
        cache = gather(cache, parent.reshape(-1))
        alive = alive.gather(1, parent)
        if eos_id is not None:
            alive = alive & (last != eos_id)
    return np.asarray(gaps)


def beam_f32_checks(torch, flash, smoke: Smoke) -> dict:
    """Part (b) of :func:`beam_phase`: the GPT also with an eos and a
    length penalty."""
    from kube_sqs_autoscaler_tpu_torch.workloads.beam import beam_search
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )

    out = {}
    requests = staggered_requests()
    for family in ("gpt", "llama"):
        config, params, model = f32_model(torch, family)
        pick = model.attention_fn_for(config, 512, "cuda")
        variants = [("beams", {})]
        if family == "gpt":
            variants.append(("beams-eos-penalty", None))
        for variant, knobs in variants:
            want, tied = {}, {}
            with torch.inference_mode():
                for start, ids, lengths in padded_batches(torch, requests, 1):
                    if knobs is None:  # an eos the first prompt's beam emits
                        first = beam_search(params, config, ids, 32,
                                            beams=BEAMS, lengths=lengths,
                                            attention_fn=pick)
                        knobs = {"eos_id": int(first[0, 3]),
                                 "length_penalty": 0.6}
                    seqs, ranked = beam_search(
                        params, config, ids, 32, beams=BEAMS, lengths=lengths,
                        attention_fn=pick, return_all=True, **knobs)
                    want[start] = seqs[0, 0].cpu().numpy()
                    gaps = beam_gaps(torch, params, config, model.full, ids,
                                     lengths, pick,
                                     eos_id=knobs.get("eos_id"))
                    low = np.flatnonzero(gaps < MARGIN)
                    if float(ranked[0, 0] - ranked[0, 1]) < MARGIN:
                        tied[start] = 0  # the final ranking is a near-tie
                    elif low.size:
                        tied[start] = int(low[0])
            batcher = ContinuousBatcher(params, config, 8, 512, 32,
                                        family=family, beams=BEAMS,
                                        device="cuda", **knobs)
            before = flash.kernel_launches
            got, cycles = staggered_drive(batcher, requests)
            launched = flash.kernel_launches - before
            # a request whose standalone search met a near-tie at step s
            # is compared over its first s tokens only
            bad = [i for i, tokens in got.items()
                   if not np.array_equal(tokens[:tied.get(i, 32)],
                                         want[i][:tied.get(i, 32)])]
            smoke.check(
                len(got) == 24 and not bad
                and launched == SERVE_LAYERS * batcher.insert_dispatches,
                f"{variant} {family} f32 slot engine {knobs}: {len(got)} of "
                f"24 staggered prompts in {cycles} cycles, "
                f"{batcher.insert_dispatches} inserts ({launched} flash_fwd "
                f"launches); equal to beam_search of each prompt alone up to "
                f"the first near-tie in its selection (gap < {MARGIN:g}): "
                f"mismatched {bad}; near-ties (request: step) {tied}")
            out[f"{family}-{variant}"] = {"mismatched": bad,
                                          "near_ties": tied}
            del batcher
        del params
    return out


def beam_profile(torch) -> dict:
    """Where a beam engine's device time goes: ``torch.profiler`` around
    a 16-message ``--beams 4`` drain of the GPT (block 1), with the parent
    gather's kernels (``index_select``) apart."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary

    config, params, service_config = demo_setup(torch, GENERATE_ARGS, 1)
    modes = ({}, {"beams": BEAMS})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = binary.run_demo(16, params, config, service_config,
                                  torch.device("cuda"), continuous=True,
                                  modes=modes)
        torch.cuda.synchronize()
    wall_ms = summary["elapsed_s"] * 1e3
    kernels, copies = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    # the parent gather's index_select runs as vectorized_gather_kernel;
    # the stable top-k over W * V continuations as a radix sort
    gather_ms = sum(ms for ms, _, key in kernels
                    if "vectorized_gather_kernel" in key)
    sort_ms = sum(ms for ms, _, key in kernels if "RadixSort" in key)
    print(f"profile beams 4 continuous (16 messages, profiler on): wall "
          f"{wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), parent gather (index_select) "
          f"{gather_ms:.3f} ms ({100 * gather_ms / busy_ms:.1f}% of busy), "
          f"top-k sort {sort_ms:.3f} ms ({100 * sort_ms / busy_ms:.1f}%), "
          f"copies {sum(ms for ms, _, _ in copies):.3f} ms", flush=True)
    for ms, count, key in kernels[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "kernel_busy_ms": busy_ms,
            "gather_ms": gather_ms, "sort_ms": sort_ms,
            "top": [(ms, count, key[:90]) for ms, count, key in kernels[:8]]}


def slice_rates(spec: dict, beams: dict) -> dict:
    """The warm ``--demo 64`` rates of plain block-1 ``--continuous``,
    speculative and beams, both families, from the runs above."""
    rates = {**beams["rates"], **spec["rates"]}
    for key in sorted(rates):
        r = rates[key]
        print(f"warm {key} --continuous --demo 64: {r['msgs_per_s']:.3f} "
              f"msgs/s, {r['tokens_per_s']:.3f} generated tokens/s, mean "
              f"TTFT {r['ttft_mean_s'] * 1e3:.3f} ms", flush=True)
    return rates


# -- the cost of the GPT's bf16 rounding repair -----------------------------

REPAIR_TRAIN_STEPS = 6


def cost_of_this_tree() -> None:
    """One JSON line of the cost numbers of the tree whose package this
    process imports: the operators a decode step of 8 rows dispatches
    (GPT and llama), the GPT decode step's time at a cache of 544
    positions, and the flagship trainer's steady bf16 step time and peak
    memory over ``REPAIR_TRAIN_STEPS`` ``--overfit`` steps."""
    import torch

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    ops = ops_per_decode_step(torch)
    config, params = binary.builtin_model("gpt", 512, 32, "cuda")
    layout = family_of(config).full
    ids = torch.zeros((8, 512), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        _, cache = layout.prefill(params, ids, config)
        start = cache["length"].clone()

        def step():
            cache["length"] = start.clone()
            layout.decode_step(params, cache, ids[:, 0], config)

        step_ms = time_ms(torch, step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.main([*TRAIN_ARGS, "--steps", str(REPAIR_TRAIN_STEPS),
                            "--log-every", "1", "--overfit"])
    torch.cuda.synchronize()
    print(json.dumps({
        "tree": str(Path(trainer.__file__).resolve().parents[2]),
        "ops_gpt": ops["gpt"], "ops_llama": ops["llama"],
        "gpt_decode_step_ms": step_ms,
        "train_step_ms": 1e3 / summary["steps_per_s"],
        "train_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": summary["losses"],
    }), flush=True)


def repair_cost_main(parent: str) -> int:
    """``python3 chip_smoke.py --repair-cost PARENT``: the cost numbers of
    :func:`cost_of_this_tree` for the checkout at ``PARENT`` (the tree
    before the repair) and for this one, in the order parent, this, this,
    parent, each in a process of its own whose package is that tree's."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    device_phase(torch)
    here = Path(__file__).resolve()
    runs = []
    for tree in (Path(parent).resolve(), ROOT, ROOT, Path(parent).resolve()):
        code = (
            "import importlib.util, sys\n"
            f"sys.path.insert(0, {str(tree)!r})\n"
            f"spec = importlib.util.spec_from_file_location('smoke', "
            f"{str(here)!r})\n"
            "smoke = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(smoke)\n"
            "smoke.cost_of_this_tree()\n"
        )
        done = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        lines = done.stdout.strip().splitlines()
        if done.returncode or not lines:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    print(json.dumps({"repair_cost": runs}), flush=True)
    return 0


def kernel_entry(name, source, replaces, replaces_fn, launches, by_path,
                 err, timing, shape) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": f"kube_sqs_autoscaler_tpu_torch/csrc/{source}",
        "replaces": f"kube_sqs_autoscaler_tpu/workloads/flash.py:{replaces}",
        "replaces_fn": replaces_fn,
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": err,
        "tol": TOL["bfloat16"],
        "shape": list(shape),
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "library_ms": timing["library_ms"],
        "library_call": timing.get("library_call",
                                   "F.scaled_dot_product_attention forward"),
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from kube_sqs_autoscaler_tpu_torch.workloads import flash, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    info = smoke.phase("device", device_phase, torch)
    power = info["nvidia_smi"] if info else "unknown"
    build = smoke.phase("build", build_phase, kernels)
    sass = build and smoke.phase("sass", sass_phase, kernels, build, smoke)
    resources = smoke.phase("resources", resources_phase, flash, smoke)
    kern = smoke.phase("kernels", kernel_phase, torch, flash, smoke)
    train_kern = smoke.phase("train kernels", train_kernel_phase, torch,
                             flash, smoke)
    path = smoke.phase("main path", main_path_phase, torch, flash, smoke)
    serve = smoke.phase("continuous", continuous_phase, torch, flash, smoke)
    cycles = smoke.phase("block cycles", block_cycles_phase, torch, smoke)
    stagger = smoke.phase("f32 staggered", staggered_phase, torch, flash,
                          smoke)
    smoke.phase("f32 prefill", f32_prefill_phase, torch, flash, smoke)
    rates = smoke.phase("throughput", throughput_phase, torch)
    prof = smoke.phase("profile", profile_phase, torch)
    serve_prof = smoke.phase("continuous profile", serve_profile_phase, torch)
    sqs = serve and smoke.phase("sqs", sqs_phase, torch, flash, smoke, serve)
    fleet = serve and smoke.phase("fleet", fleet_phase, torch, flash, smoke,
                                  serve)
    shards = serve and stagger and smoke.phase(
        "shards", shards_phase, torch, flash, smoke, serve, stagger, fleet)
    llama = smoke.phase("llama", llama_phase, torch, flash, smoke)
    int8 = smoke.phase("int8", int8_phase, torch, flash, smoke)
    prefix = smoke.phase("prefix", prefix_phase, torch, flash, smoke)
    spec = smoke.phase("speculative", speculative_phase, torch, flash, smoke)
    beams = smoke.phase("beam", beam_phase, torch, flash, smoke)
    slice_prof = smoke.phase("beam profile", beam_profile, torch)
    spec and beams and smoke.phase("slice rates", slice_rates, spec, beams)
    odd = smoke.phase("odd head dim", odd_head_dim_phase, torch, flash, smoke)
    f32_train = smoke.phase("f32 train step", f32_train_phase, torch, flash,
                            smoke)
    train_path = smoke.phase("train path", train_path_phase, torch, flash,
                             smoke, power)
    train_prof = smoke.phase("train profile", train_profile_phase, torch)
    if smoke.failures or not (info and sass and resources and kern
                              and train_kern and path and serve and cycles
                              and stagger and rates and prof
                              and serve_prof and sqs and fleet and shards
                              and llama and int8 and prefix and spec
                              and beams and slice_prof and odd
                              and f32_train and train_path and train_prof):
        print(f"chip_smoke: {len(smoke.failures)} failure(s): "
              f"{smoke.failures}", file=sys.stderr)
        return 1
    timing = dict(kern["timings"][MAIN_SHAPES[0]])
    by_path = {
        **{f"serve-{m}": v["launches"] for m, v in path.items()},
        **{f"serve-{m}": serve[m]["launches"]
           for m in ("continuous-b1", "continuous-b8")},
        # the binary on the SQS emulator, continuous and batch
        "serve-sqs": sum(sqs[m]["launches"]
                         for m in ("continuous-b8", "generate")),
        # the bf16 fleet episode and the binary's --fleet-max-replicas
        "serve-fleet": fleet["bf16"]["launches"]
        + fleet["binary"]["launches"],
        # the sharded plane: S = 1, the binary's --shards 4, the bf16
        # chaos episode (its resume inserts included)
        "serve-shards": shards["s1"]["launches"]
        + shards["binary"]["launches"] + shards["chaos"]["bf16"]["launches"],
        # the llama family: batch, blocks 1 and 8, S = 1, --shards 4 and
        # --fleet-max-replicas 3, GQA at H_kv = 2
        **llama["launches"],
        # int8 weights and cache (batch, blocks 1 and 8, S = 1), and the
        # shared prefix (its one prompt pass a run; the suffixes none)
        **int8["launches"],
        **prefix["launches"],
        # speculative (batch: target and draft prefills; slots: one target
        # prefill an insert) and beams (one prompt pass a batch or insert)
        **spec["launches"],
        **beams["launches"],
        **{f"train-{r}": v["launches"]["flash_fwd"]
           for r, v in train_path.items()},
    }
    fwd = kernel_entry(
        "flash_fwd", "flash_fwd.cu", 159, "_fwd_kernel (need_lse=False)",
        sum(by_path.values()), by_path,
        max(kern["main_err"], kern["llama_err"]), timing, MAIN_SHAPES[0])
    fwd["at_other_shapes"] = {
        "x".join(map(str, shape)): t for shape, t in
        kern["timings"].items() if shape != MAIN_SHAPES[0]
    }
    # the llama shapes, (B, H, H_kv, S, D) with the window where there is one
    for label, (shape, window) in LLAMA_SHAPES.items():
        key = "x".join(map(str, shape)) + (f"-w{window}" if window else "")
        fwd["at_other_shapes"][key] = kern["llama_timings"][label]
    fwd["at_other_shapes"]["x".join(map(str, TRAIN_SHAPE))] = \
        train_kern["timings"]["flash_fwd"]
    fwd["tflops"] = timing["tflops"]
    entries = [fwd]
    for name, source, line, fn in (
            ("flash_fwd_lse", "flash_fwd.cu", 159,
             "_fwd_kernel (need_lse=True, lse written at :247-251)"),
            ("flash_bwd_dq", "flash_bwd.cu", 324, "_bwd_dq_kernel"),
            ("flash_bwd_dkv", "flash_bwd.cu", 380, "_bwd_dkv_kernel")):
        entry = kernel_entry(
            name, source, line, fn,
            train_path["train"]["launches"][name],
            {f"train-{r}": v["launches"][name]
             for r, v in train_path.items()},
            train_kern["errs"][name], train_kern["timings"][name],
            TRAIN_SHAPE)
        entry["tflops"] = train_kern["timings"][name]["tflops"]
        entries.append(entry)
    for entry in entries:
        # the instantiation the main paths run: bf16, D = 64
        kernel = entry["name"].removesuffix("_lse")
        used = resources[(kernel, "bf16", TRAIN_SHAPE[3])]
        entry["registers"] = used["registers"]
        entry["spill_bytes"] = used["local_bytes"]
        entry["hmma_instructions"] = sass[f"{kernel} bf16 {TRAIN_SHAPE[3]}"]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--repair-cost":
        sys.exit(repair_cost_main(sys.argv[2]))
    sys.exit(main())
