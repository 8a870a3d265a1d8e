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
   continuous engine's refill sizes 1 and 3 and at the train shape, where
   the eval passes run it), and the training forward with
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
   decode dispatch and one host wait a cycle; the share of settles that
   found the next block still running); and the batcher in f32 at full
   width over 24 ragged prompts submitted a few at a time at blocks 1 and
   8, each request against ``generate`` for its prompt alone up to the
   first near-tie;
6. throughput and profile: warm ``--demo 64`` rates in each mode (the
   continuous engine's with its mean time to first token), and
   ``torch.profiler`` over one batch in each mode and over a 16-message
   continuous drain at blocks 1 and 8 (device busy share and the kernels
   that take the time);
7. training: an f32 loss and gradient at the flagship train width through
   the kernels against the dense-attention path; the trainer binary's code
   path in-process at the flagship config (GPT, d_model 1024, 16 heads,
   8 layers, d_ff 4096, vocab 8192, B=8, S=2048) in bf16 for 10
   ``--overfit`` steps, whose losses must be finite and fall and whose
   lse-forward, dq and dk/dv launch counts must each be ``n_layers x
   steps`` (and twice that for the forward under ``--remat``); its steady
   step time, tokens/s, MFU and peak memory; ``torch.profiler`` over one
   step;
8. a JSON line ``{"kernels": [...]}`` with each kernel's numbers;
9. the last line, ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and exits non-zero without a
card or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import traceback
from functools import partial

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
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            self.failures.append(f"phase {name} raised")
            return None


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
    """q, k, v on the card; ``strided`` takes them as the model does, as
    head views of one fused [B, S, 3 * H * D] projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        assert heads == kv_heads
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
        ("ragged-s48", 8, 8, 8, 48, 64, None, False),
        ("ragged-s7", 8, 8, 8, 7, 64, None, True),
        ("ragged-s1000", 8, 8, 8, 1000, 64, None, True),
        ("bucket-s16", 8, 8, 8, 16, 64, None, True),
        ("gqa-h8-kv2-d128", 2, 8, 2, 512, 128, None, False),
        ("window128-s1024", 2, 8, 8, 1024, 64, 128, False),
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
    for shape in MAIN_SHAPES:
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
    return {"cases": results, "main_err": main_err, "timings": timings}


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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
                     "host_transfers": summary["host_transfers"]}
        print(f"{mode}: launches {launched}, inserts {inserts}, decode "
              f"dispatches {summary['decode_dispatches']}, host transfers "
              f"{summary['host_transfers']}", flush=True)
    for mode in ("continuous-b1", "continuous-b8"):
        same = replies[mode] == replies["generate"]
        smoke.check(same, f"{mode}: the {len(replies[mode])} replies are "
                    "identical to the batch worker's (bf16, greedy)")
    return out


def demo_setup(torch, argv: list[str], decode_block: int = 1):
    """The worker binary's built-in config, seeded weights and service
    config for ``argv``, on the card."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.model import init_params
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    args = binary.build_parser().parse_args(argv)
    config = binary.builtin_config(args.seq_len, args.generate_tokens)
    params = init_params(config, torch.Generator().manual_seed(0), "cuda")
    service_config = ServiceConfig(
        queue_url="", batch_size=args.batch_size, seq_len=args.seq_len,
        generate_tokens=args.generate_tokens,
        result_queue_url=args.result_queue_url, decode_block=decode_block,
    )
    return config, params, service_config


def block_cycles_phase(torch, smoke: Smoke) -> dict:
    """The continuous worker's cycles at decode block 8, driven one by
    one over the demo traffic: each may launch at most one decode and
    wait at most once for the host; and the share of block settles at
    which the block dispatched that cycle was still running."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )

    config, params, service_config = demo_setup(torch, GENERATE_ARGS, 8)
    service_config.queue_url = "demo://queue"
    service_config.result_queue_url = ""
    rng = np.random.default_rng(0)
    queue = FakeMessageQueue()
    for _ in range(64):
        queue.send_message(service_config.queue_url, json.dumps(
            rng.integers(0, config.vocab_size, 512).tolist()))
    worker = ContinuousWorker(queue, params, config, service_config,
                              device="cuda")
    batcher = worker.batcher
    worst = [0, 0]
    cycles = 0
    while worker.processed < 64 and cycles < 1000:
        before = (batcher.decode_dispatches, batcher.host_transfers)
        worker.run_once()
        cycles += 1
        worst = [max(worst[0], batcher.decode_dispatches - before[0]),
                 max(worst[1], batcher.host_transfers - before[1])]
    smoke.check(worker.processed == 64 and worst[0] <= 1 and worst[1] <= 1,
                f"block 8: {worker.processed} of 64 served in {cycles} "
                f"cycles, at most {worst[0]} decode dispatch and "
                f"{worst[1]} host transfer a cycle (want <= 1 each)")
    share = batcher.overlapped_settles / max(1, batcher.block_settles)
    print(f"block 8: {batcher.overlapped_settles} of {batcher.block_settles} "
          f"block settles found the next block still running "
          f"({100 * share:.1f}%), block utilization "
          f"{batcher.block_tokens / batcher.block_capacity:.4f}", flush=True)
    return {"cycles": cycles, "overlapped_settles": batcher.overlapped_settles,
            "block_settles": batcher.block_settles, "overlap_share": share}


def greedy_margins(torch, params, config, prompt, tokens):
    """The top-two margin of the logits that chose each of ``tokens``
    (one dense-attention forward over the prompt and its continuation)."""
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
        waiting, got, cycle = list(enumerate(requests)), {}, 0
        while (waiting or batcher.active) and cycle < 5000:
            free = len(batcher.free_slots)
            if waiting and free and cycle % 3 == 0:
                take = min(free, 3)
                batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
                waiting = waiting[take:]
            for i, tokens in batcher.step():
                got[i] = tokens
            cycle += 1
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
    return out


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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    f32_train = smoke.phase("f32 train step", f32_train_phase, torch, flash,
                            smoke)
    train_path = smoke.phase("train path", train_path_phase, torch, flash,
                             smoke, power)
    train_prof = smoke.phase("train profile", train_profile_phase, torch)
    if smoke.failures or not (info and sass and resources and kern
                              and train_kern and path and serve and cycles
                              and stagger and rates and prof
                              and serve_prof and f32_train and train_path
                              and train_prof):
        print(f"chip_smoke: {len(smoke.failures)} failure(s): "
              f"{smoke.failures}", file=sys.stderr)
        return 1
    timing = dict(kern["timings"][MAIN_SHAPES[0]])
    fwd = kernel_entry(
        "flash_fwd", "flash_fwd.cu", 159, "_fwd_kernel (need_lse=False)",
        sum(m["launches"] for m in path.values())
        + sum(serve[m]["launches"] for m in ("continuous-b1",
                                             "continuous-b8"))
        + train_path["train"]["launches"]["flash_fwd"],
        {**{f"serve-{m}": v["launches"] for m, v in path.items()},
         **{f"serve-{m}": serve[m]["launches"]
            for m in ("continuous-b1", "continuous-b8")},
         **{f"train-{r}": v["launches"]["flash_fwd"]
            for r, v in train_path.items()}},
        kern["main_err"], timing, MAIN_SHAPES[0])
    fwd["at_other_shapes"] = {
        "x".join(map(str, shape)): t for shape, t in
        kern["timings"].items() if shape != MAIN_SHAPES[0]
    }
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
    sys.exit(main())
