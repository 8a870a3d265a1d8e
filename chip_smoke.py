"""Chip smoke test of the PyTorch port on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure makes the run exit non-zero and print no result):

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: every CUDA source under ``kube_sqs_autoscaler_tpu_torch/csrc``
   (one ``nvcc`` each, in parallel) into ``build/kernels/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes and at the ragged, GQA and windowed shapes, and
   timed beside its plain version, the equivalent PyTorch library call
   and the least time the card could take (its bound);
4. main path: the worker binary's code path in-process, at the built-in
   GPT's full width in bf16, in generate and classify mode; every message
   must be answered once and deleted, and every kernel of the path must
   have launched (the launch counts are zeroed just before each mode and
   read just after); plus an f32 prefill whose logits must match the
   dense-attention path;
5. throughput and profile: warm ``--demo 64`` rates in each mode, and
   ``torch.profiler`` over one batch in each mode (device busy share and
   the kernels that take the time);
6. a JSON line ``{"kernels": [...]}`` with each kernel's numbers;
7. the last line, ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and exits non-zero without a
card or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback

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
MAIN_SHAPES = [(8, 8, 512, 64), (8, 8, 1024, 64)]  # generate, classify
GENERATE_ARGS = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
                 "--generate-tokens", "32", "--result-queue-url",
                 "demo://replies"]
CLASSIFY_ARGS = ["--demo", "16", "--batch-size", "8", "--seq-len", "1024",
                 "--result-queue-url", "demo://replies"]


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
    return {"build_s": seconds}


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


def flash_bound_ms(shape, kv_heads, dtype_name, causal=True, window=None):
    """The least time the card could take for the kernel's work: q, k, v
    read once and out written once over the memory rate, or the two
    products' multiply-adds over the peak rate of the inputs' type,
    whichever is longer; the products count only the live (row, key)
    pairs of this mask."""
    batch, heads, seq, dim = shape
    size = 2 if dtype_name == "bfloat16" else 4
    moved = (2 * batch * heads * seq * dim
             + 2 * batch * kv_heads * seq * dim) * size
    if not causal:
        pairs = seq * seq
    elif window is None:
        pairs = seq * (seq + 1) // 2
    else:
        pairs = sum(min(r + 1, window) for r in range(seq))
    ops = 4 * batch * heads * dim * pairs
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, flash, smoke: Smoke) -> dict:
    import torch.nn.functional as F

    cases = [
        # (label, batch, heads, kv_heads, seq, dim, window, strided)
        ("generate-prefill", 8, 8, 8, 512, 64, None, True),
        ("classify", 8, 8, 8, 1024, 64, None, True),
        ("ragged-s48", 8, 8, 8, 48, 64, None, False),
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
        timings[shape] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        print(f"time flash_fwd bf16 {shape}: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
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
    """Warm end-to-end rates: the binary's ``--demo 64`` in each mode,
    after the main path has paid the one-time costs (library load, cuBLAS
    set-up)."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as worker

    out = {}
    for mode, args in (("generate", GENERATE_ARGS),
                       ("classify", CLASSIFY_ARGS)):
        args = list(args)
        args[args.index("--demo") + 1] = "64"
        summary = worker([*args, "--device", "cuda"])
        out[mode] = {k: summary[k] for k in (
            "msgs_per_s", "tokens_per_s", "elapsed_s", "processed")}
        out[mode]["cycle_p50_s"] = summary["cycle"]["p50_s"]
        print(f"warm {mode} --demo 64: {summary['msgs_per_s']:.3f} msgs/s, "
              f"{summary['tokens_per_s']:.3f} generated tokens/s, cycle p50 "
              f"{summary['cycle']['p50_s'] * 1e3:.3f} ms", flush=True)
    return out


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
        kernels, copies = [], []
        for event in prof.key_averages():
            # device rows only: operator rows repeat their kernels' time
            if not str(event.device_type).endswith("CUDA"):
                continue
            device_us = getattr(event, "self_device_time_total", None)
            if device_us is None:
                device_us = event.self_cuda_time_total
            if device_us > 0:
                row = (device_us / 1e3, event.count, event.key)
                # copies are listed apart: the trace may also hold the
                # weights' host-to-device copies, made before the window
                is_copy = event.key.startswith(("Memcpy", "Memset"))
                (copies if is_copy else kernels).append(row)
        kernels.sort(reverse=True)
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
    smoke.phase("build", build_phase, kernels)
    kern = smoke.phase("kernels", kernel_phase, torch, flash, smoke)
    path = smoke.phase("main path", main_path_phase, torch, flash, smoke)
    smoke.phase("f32 prefill", f32_prefill_phase, torch, flash, smoke)
    rates = smoke.phase("throughput", throughput_phase, torch)
    prof = smoke.phase("profile", profile_phase, torch)
    if smoke.failures or not (info and kern and path and rates and prof):
        print(f"chip_smoke: {len(smoke.failures)} failure(s): "
              f"{smoke.failures}", file=sys.stderr)
        return 1
    timing = kern["timings"][MAIN_SHAPES[0]]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "kube_sqs_autoscaler_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "kube_sqs_autoscaler_tpu/workloads/flash.py:159",
        "replaces_fn": "_fwd_kernel",
        "launches": sum(m["launches"] for m in path.values()),
        "launches_by_mode": {m: v["launches"] for m, v in path.items()},
        "max_abs_err": kern["main_err"],
        "tol": TOL["bfloat16"],
        "shape": list(MAIN_SHAPES[0]),
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "library_ms": timing["library_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "at_other_shapes": {
            "x".join(map(str, shape)): t for shape, t in
            kern["timings"].items() if shape != MAIN_SHAPES[0]
        },
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
