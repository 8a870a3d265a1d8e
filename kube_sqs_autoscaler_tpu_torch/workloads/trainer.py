"""Trainer binary: ``python -m kube_sqs_autoscaler_tpu_torch.workloads.trainer``.

Counterpart of ``python -m kube_sqs_autoscaler_tpu.workloads.trainer`` in
its GPT, single-device, dense branch: seeded weights, the synthetic token
stream prefetched to the device, the train step of :mod:`.train` (remat,
grad accumulation, warmup-cosine schedule, global-norm clip), a fixed
held-out eval set, and the reference's log line
``step N loss L (steps/s, tokens/s, MFU)``.

It runs on the card (``--device cuda``, the default), where every
attention forward and backward is a hand-written CUDA kernel, and exits
with an error when there is none; ``--device cpu`` runs it on the CPU with
dense attention.

Not ported yet (their flags are not accepted): the llama family, MoE,
LoRA, the pipeline / sequence / model-parallel meshes and zig-zag,
checkpoint/resume, HF import/export, on-disk corpora (``--data-dir``),
device tracing (``--profile-dir``) and ``--metrics-port``.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import time

import torch

from ..device import resolve_device
from ..utils.logging import configure_logging
from .data import prefetch_to_device, synthetic_token_stream
from .flash import attention_fn_for
from .model import ModelConfig, param_count
from .perf import mfu as mfu_of, train_step_flops
from .train import TrainConfig, init_train_state, loss_fn, make_train_step

log = logging.getLogger("trainer")

EVAL_SEED_OFFSET = 0x5EED  # the held-out set's seed domain


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kube-sqs-autoscaler-torch-trainer")
    parser.add_argument(
        "--family", choices=("gpt", "llama"), default="gpt",
        help="gpt: learned positions/MHA/LayerNorm/GELU (llama is not "
             "ported yet)",
    )
    parser.add_argument("--vocab-size", type=int, default=8192)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--d-ff", type=int, default=2048)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--decay-steps", type=int, default=0)
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument(
        "--grad-clip-norm", type=float, default=0.0,
        help="clip the global gradient norm to this before the AdamW "
             "update (0 = off)",
    )
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument(
        "--eval-every", type=int, default=0, metavar="N",
        help="every N steps, evaluate mean loss on a fixed held-out set "
             "(--eval-batches batches from a disjoint seed domain; 0 = "
             "no eval)",
    )
    parser.add_argument("--eval-batches", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--overfit", action="store_true",
        help="repeat the first batch every step: the smoke test that the "
             "whole stack can drive the loss toward zero",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where training runs (default cuda; no card is an error, "
             "never a quiet CPU run)",
    )
    return parser


def setup(args) -> dict:
    """The run's pieces from parsed flags: ``device``, ``model_config``,
    ``state`` (seeded weights, AdamW) and ``step_fn``."""
    if args.family != "gpt":
        raise SystemExit(
            f"error: --family {args.family} is not ported yet (gpt only)"
        )
    if args.eval_every > 0 and args.eval_batches < 1:
        raise SystemExit("--eval-every needs --eval-batches >= 1")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    train_config = TrainConfig(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, remat=args.remat,
        grad_accum=args.grad_accum, grad_clip_norm=args.grad_clip_norm,
    )
    model_config = ModelConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_heads=args.n_heads, n_layers=args.n_layers, d_ff=args.d_ff,
        max_seq_len=args.seq_len,
    )
    state = init_train_state(torch.Generator().manual_seed(args.seed),
                             model_config, train_config, device)
    return {
        "device": device, "model_config": model_config, "state": state,
        "step_fn": make_train_step(model_config, train_config, device),
    }


def train(args) -> dict:
    """Run the loop; returns ``{"losses": [...], "final_step": int}`` plus
    ``steps_per_s``, ``tokens_per_s`` and ``mfu`` over every logged
    interval after the first (``None`` with a single interval; ``mfu`` is
    ``None`` off a known card)."""
    run = setup(args)
    device, model_config = run["device"], run["model_config"]
    state, step_fn = run["state"], run["step_fn"]
    log.info("Model: %s parameters on %s",
             f"{param_count(state['params']):,}", device)

    eval_data = None
    eval_attention = attention_fn_for(args.seq_len, device,
                                      model_config.head_dim)
    if args.eval_every > 0:
        # a fixed held-out set from a disjoint seed domain of the source
        eval_stream = synthetic_token_stream(
            model_config.vocab_size, args.batch_size, args.seq_len,
            seed=args.seed + EVAL_SEED_OFFSET,
        )
        eval_data = [torch.from_numpy(next(eval_stream)).to(device)
                     for _ in range(args.eval_batches)]

    def run_eval() -> float:
        # no recorded gradient: the attention runs the forward kernel
        # without the lse
        with torch.no_grad():
            return sum(
                float(loss_fn(state["params"], tokens, model_config,
                              eval_attention))
                for tokens in eval_data
            ) / len(eval_data)

    stream = synthetic_token_stream(model_config.vocab_size, args.batch_size,
                                    args.seq_len, seed=args.seed)
    if args.overfit:
        stream = itertools.repeat(next(stream))
    batches = prefetch_to_device(stream, device)
    step_flops = train_step_flops(model_config, args.batch_size, args.seq_len)

    losses = []
    timed_steps, timed_s = 0, 0.0  # every logged interval after the first
    log_every = max(1, args.log_every)
    # throughput is per logging interval (float(loss) is the sync point),
    # and the interval holding the first step is excluded: it pays the
    # one-time costs (kernel builds, allocator growth, library set-up)
    interval_start = time.perf_counter()
    interval_steps = 0
    for local_step in range(args.steps):
        state, loss = step_fn(state, next(batches))
        interval_steps += 1
        step = state["step"]
        if local_step % log_every == 0 or local_step == args.steps - 1:
            loss_value = float(loss)  # sync point, only when logging
            losses.append(loss_value)
            now = time.perf_counter()
            rate = ""
            if local_step > 0:
                steps_per_s = interval_steps / (now - interval_start)
                tokens_per_s = steps_per_s * args.batch_size * args.seq_len
                mfu_value = mfu_of(step_flops, 1.0 / steps_per_s, device)
                timed_steps += interval_steps
                timed_s += now - interval_start
                rate = f" ({steps_per_s:.2f} steps/s, " \
                       f"{tokens_per_s:.0f} tokens/s" + (
                           f", {mfu_value:.1%} MFU"
                           if mfu_value is not None else ""
                       ) + ")"
            interval_start = now
            interval_steps = 0
            log.info("step %d loss %.4f%s", step, loss_value, rate)
        if eval_data is not None and step % args.eval_every == 0:
            eval_loss = run_eval()
            log.info("step %d eval_loss %.4f (%d held-out batches)",
                     step, eval_loss, len(eval_data))
            # eval time is not charged to the training interval
            interval_start = time.perf_counter()
            interval_steps = 0
    steps_per_s = timed_steps / timed_s if timed_steps else None
    return {
        "losses": losses, "final_step": state["step"],
        "steps_per_s": steps_per_s,
        "tokens_per_s": steps_per_s and steps_per_s * args.batch_size
        * args.seq_len,
        "mfu": steps_per_s and mfu_of(step_flops, 1.0 / steps_per_s, device),
    }


def main(argv=None) -> dict:
    configure_logging()
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
