"""Trainer binary: ``python -m kube_sqs_autoscaler_tpu_torch.workloads.trainer``.

Counterpart of ``python -m kube_sqs_autoscaler_tpu.workloads.trainer`` on
one device.  Both families (``--family gpt|llama``, the llama with GQA
``--n-kv-heads`` and a Mistral-style ``--sliding-window``), dense or with
routed experts (``--moe``), full training or rank-``r`` adapters on a
frozen base (``--lora-rank``, with ``--moe`` too); seeded weights or an
HF Llama/Mistral checkpoint (``--hf-checkpoint``); the synthetic token
stream or an on-disk corpus (``--data-dir``, the native mmap reader);
the train step of :mod:`.train` (remat, grad accumulation, warmup-cosine
schedule, global-norm clip), a fixed held-out eval set, checkpoints with
resume and retention (:mod:`.checkpoint`; the worker serves them), an HF
export of the final weights (``--hf-export``), a ``torch.profiler``
trace of the loop (``--profile-dir``) and ``/metrics`` with the train
gauges (``--metrics-port``).  The log line is the reference's ``step N
loss L (steps/s, tokens/s, MFU)``.

It runs on the card (``--device cuda``, the default), where every
attention forward and backward is a hand-written CUDA kernel (the
GQA-native and windowed kernels for the llama), and exits with an error
when there is none; ``--device cpu`` runs it on the CPU with dense
attention.

Launched over ranks (``python -m torch.distributed.run --nproc-per-node
N -m kube_sqs_autoscaler_tpu_torch.workloads.trainer ...``) it trains on a
``("data", "seq", "model")`` mesh (:mod:`.distributed`):
``--model-parallel`` (Megatron tensor parallelism), ``--seq-parallel``
(ring attention, :mod:`.ring`; ``--zigzag`` for the balanced schedule,
:mod:`.zigzag`) and data parallelism over the rest, ``--topology-mesh``
ordering the ranks node-major.  Rank 0 alone logs, serves ``/metrics`` and
writes checkpoints, which hold the full tensors (a tensor-parallel run's
slices gathered), so the single-card worker serves them; ``--resume``
slices them again per rank.  ``--moe`` splits the experts over ``data``
and routes over the global token stream; ``--lora-rank`` replicates the
adapters over a sliced frozen base.  ``--pipe-parallel P`` trains on a
``("pipe", "data", "seq", "model")`` mesh (:mod:`.pipeline`): each rank
holds ``n_layers / P`` stage layers, the batch runs as
``--pipe-microbatches`` microbatches on the ``--pipe-schedule`` (GPipe or
1F1B), with ``--model-parallel``, ``--seq-parallel`` (``--zigzag``),
``--moe`` and ``--lora-rank`` inside the stages; its checkpoints hold the
full stage stacks (the ``pipeline`` layout), which the worker serves.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import logging
import os
import time
from pathlib import Path

import torch

from ..device import resolve_device
from ..utils.logging import configure_logging
from ..utils.profiling import maybe_trace
from .data import corpus_token_stream, prefetch_to_device, synthetic_token_stream
from .flash import attention_fn_for, windowed
from .llama import LlamaConfig
from .model import ModelConfig
from .perf import mfu as mfu_of, train_step_flops
from .train import TrainConfig, loss_fn, next_token_nll

log = logging.getLogger("trainer")

EVAL_SEED_OFFSET = 0x5EED  # the held-out set's seed domain


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kube-sqs-autoscaler-torch-trainer")
    # model (defaults sized for a quick single-card run)
    parser.add_argument(
        "--family", choices=("gpt", "llama"), default="gpt",
        help="gpt: learned positions/MHA/LayerNorm/GELU; "
             "llama: RoPE/GQA/RMSNorm/SwiGLU",
    )
    parser.add_argument("--vocab-size", type=int, default=8192)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-kv-heads", type=int, default=2,
                        help="llama family only: GQA KV head count")
    parser.add_argument(
        "--sliding-window", type=int, default=0, metavar="W",
        help="llama family only: Mistral-style sliding-window attention "
             "(each position attends its last W keys; 0 = full causal)",
    )
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument(
        "--d-ff", type=int, default=None,
        help="default: 2048 (gpt GELU), 1408 (llama SwiGLU convention, "
             "matching the serving binary)",
    )
    parser.add_argument("--seq-len", type=int, default=256)
    # schedule / optimization
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--decay-steps", type=int, default=0)
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument(
        "--grad-clip-norm", type=float, default=0.0,
        help="clip the global gradient norm before the optimizer update "
             "(0 = off)",
    )
    parser.add_argument("--remat", action="store_true")
    # parallelism: over the ranks of torch.distributed.run
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="tensor-parallel degree (ranks per model "
                             "slice group)")
    parser.add_argument("--seq-parallel", type=int, default=1,
                        help="sequence-parallel degree (ring attention)")
    parser.add_argument(
        "--zigzag", action="store_true",
        help="balanced zig-zag schedule for the seq axis (needs "
             "seq-parallel >= 2)",
    )
    parser.add_argument(
        "--pipe-parallel", type=int, default=1,
        help="pipeline-parallel stages over a "
             "('pipe','data'[,'model'|'seq']) mesh",
    )
    parser.add_argument(
        "--pipe-schedule", choices=("gpipe", "1f1b"), default="gpipe",
        help="gpipe: all-forward-then-all-backward; 1f1b: interleaved, "
             "min(M, P) live stage inputs",
    )
    parser.add_argument(
        "--pipe-microbatches", type=int, default=4,
        help="microbatches per step; batch-size must divide by it",
    )
    # mixture-of-experts (both families)
    parser.add_argument(
        "--moe", action="store_true",
        help="replace the dense MLP with a top-k routed expert MLP (GELU "
             "experts for gpt, SwiGLU experts for llama)",
    )
    parser.add_argument("--moe-experts", type=int, default=8)
    parser.add_argument("--moe-top-k", type=int, default=2)
    # parameter-efficient fine-tuning
    parser.add_argument(
        "--lora-rank", type=int, default=0,
        help="train rank-N LoRA adapters on a frozen base instead of full "
             "weights (0 = off); checkpoints save the MERGED weights, so "
             "the serve binary works unchanged",
    )
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument(
        "--hf-checkpoint", default="", metavar="DIR",
        help="start from a Hugging Face Llama checkpoint directory "
             "(workloads.hf_convert; implies --family llama and the "
             "architecture from its config) — the usual base for "
             "--lora-rank fine-tuning",
    )
    parser.add_argument(
        "--hf-export", default="", metavar="DIR",
        help="after training, export the final weights (LoRA-merged when "
             "--lora-rank is set) as a transformers-loadable Llama/"
             "Mistral checkpoint directory (llama family only)",
    )
    parser.add_argument(
        "--topology-mesh", action="store_true",
        help="order the ranks node-major (seq and model groups inside a "
             "node, data across nodes)",
    )
    # data
    parser.add_argument(
        "--data-dir", default="", metavar="DIR",
        help="train on an on-disk token corpus (*.bin shards + meta.json, "
             "see native.tokenreader.write_token_shards) through the "
             "native mmap reader; default: the synthetic stream",
    )
    # ops
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument(
        "--checkpoint-keep", type=int, default=0,
        help="retain only the newest N step checkpoints (0 = keep all)",
    )
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--profile-dir", default="")
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve /metrics with tokens/s, MFU and loss gauges "
             "(0 = disabled)",
    )
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument(
        "--eval-every", type=int, default=0, metavar="N",
        help="every N steps, evaluate mean loss on a fixed held-out set "
             "(--eval-batches batches drawn from a disjoint seed domain "
             "of the same source; 0 = no eval)",
    )
    parser.add_argument("--eval-batches", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--overfit", action="store_true",
        help="repeat the first batch every step — the standard smoke test "
             "that the whole stack can drive the loss toward zero",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where training runs (default cuda; no card is an error, "
             "never a quiet CPU run)",
    )
    return parser


def pipeline_usage(args) -> str | None:
    """The reference's checks of the pipeline flags
    (``trainer.py:219-259``), or ``None``; they apply only with
    ``--pipe-parallel`` above 1, as the reference's do."""
    if args.pipe_parallel < 1:
        return f"--pipe-parallel {args.pipe_parallel} must be >= 1"
    if args.pipe_parallel == 1:
        return None
    if args.zigzag:
        if args.seq_parallel < 2:
            return "--zigzag with --pipe-parallel needs --seq-parallel >= 2"
        for flag, bad in (("--moe", args.moe),
                          ("--lora-rank", bool(args.lora_rank)),
                          ("--sliding-window", bool(args.sliding_window))):
            if bad:
                return (f"--zigzag with --pipe-parallel does not combine "
                        f"with {flag}")
    if args.pipe_microbatches < 1 or \
            args.batch_size % args.pipe_microbatches:
        return (f"--batch-size {args.batch_size} not divisible by "
                f"--pipe-microbatches {args.pipe_microbatches}")
    if args.seq_parallel > 1 and args.moe:
        return ("--moe with --pipe-parallel does not combine with "
                "--seq-parallel")
    return None


def mesh_usage(args) -> str | None:
    """The usage error of the mesh flags, or ``None``: the reference's
    checks, and a mesh that does not divide the ranks of this launch
    (``WORLD_SIZE``; 1 in a lone process)."""
    from .distributed import mesh_shape, pipeline_mesh_shape

    refusal = pipeline_usage(args)
    if refusal:
        return refusal
    for flag, value in (("--model-parallel", args.model_parallel),
                        ("--seq-parallel", args.seq_parallel)):
        if value < 1:
            return f"{flag} {value} must be >= 1"
    if args.zigzag and args.seq_parallel < 2:
        return "--zigzag: zig-zag needs a nontrivial seq axis (P >= 2)"
    if args.zigzag and args.sliding_window:
        return ("--zigzag: sliding_window does not compose with the zig-zag "
                "schedule; use plain sequence parallelism (windowed ring "
                "attention) or a (data, model) mesh")
    shards = 2 * args.seq_parallel if args.zigzag else args.seq_parallel
    if args.seq_len % shards:
        return (f"--seq-len {args.seq_len} not divisible by {shards} "
                "sequence shards")
    world = int(os.environ.get("WORLD_SIZE", "").strip() or 1)
    try:
        if args.pipe_parallel > 1:
            pipeline_mesh_shape(world, args.pipe_parallel,
                                args.model_parallel, args.seq_parallel)
        else:
            mesh_shape(world, args.model_parallel, args.seq_parallel)
    except ValueError as err:
        flags = " ".join(
            f for f, used in (
                ("--topology-mesh", args.topology_mesh),
                (f"--pipe-parallel {args.pipe_parallel}",
                 args.pipe_parallel != 1),
                (f"--model-parallel {args.model_parallel}",
                 args.model_parallel != 1),
                (f"--seq-parallel {args.seq_parallel}",
                 args.seq_parallel != 1)) if used)
        return (f"{flags} over {world} rank(s): {err} (launch the ranks "
                "with python -m torch.distributed.run --nproc-per-node N)")
    return None


def check_args(args) -> None:
    """The reference's argument checks (``trainer.py:225-310``), before
    any device work."""
    if args.lora_rank and args.moe and args.zigzag:
        raise SystemExit(
            "--lora-rank with --moe does not combine with --zigzag"
        )
    refusal = mesh_usage(args)
    if refusal:
        raise SystemExit(refusal)
    if args.sliding_window < 0:
        raise SystemExit(
            f"--sliding-window {args.sliding_window} must be >= 0 "
            "(0 = full causal)"
        )
    if args.sliding_window and args.family != "llama":
        raise SystemExit(
            "--sliding-window is a llama-family knob (the gpt family has "
            "no windowed config)"
        )
    if args.sliding_window and args.hf_checkpoint:
        raise SystemExit(
            "--sliding-window does not combine with --hf-checkpoint (the "
            "HF config carries the architecture, window included — a "
            "Mistral import brings its own)"
        )
    if args.hf_checkpoint:
        if args.moe:
            raise SystemExit(
                "--hf-checkpoint is a llama-family base; it does not "
                "combine with --moe"
            )
        if args.family != "llama":
            log.info("--hf-checkpoint implies --family llama")
            args.family = "llama"
    if args.eval_every > 0 and args.eval_batches < 1:
        raise SystemExit("--eval-every needs --eval-batches >= 1")
    if args.hf_export:
        for flag, bad in (("--family gpt", args.family != "llama"),
                          ("--moe", args.moe)):
            if bad:
                raise SystemExit(
                    f"--hf-export writes llama-family checkpoints; it "
                    f"does not combine with {flag}"
                )
        # probe BEFORE training: a missing package discovered after a
        # long run would lose the weights
        if importlib.util.find_spec("transformers") is None:
            raise SystemExit(
                "--hf-export needs torch + transformers (No module named "
                "'transformers')"
            )
    if args.data_dir:
        from ..native.tokenreader import read_meta

        try:
            args.corpus_vocab = int(read_meta(args.data_dir)["vocab_size"])
        except FileNotFoundError as err:
            raise SystemExit(
                f"--data-dir {args.data_dir}: {err} (write shards with "
                "native.tokenreader.write_token_shards)"
            ) from None


def checkpoint_layout(args) -> dict | None:
    """The manifest's ``layout`` record of this run (the reference's)."""
    pipe = args.pipe_parallel
    if args.moe:
        layout = {"kind": "moe", "n_experts": args.moe_experts,
                  "top_k": args.moe_top_k}
        if pipe > 1:
            layout["pipeline_stages"] = pipe
        if args.lora_rank:
            layout["lora_rank"] = args.lora_rank
            layout["seed"] = args.seed
        return layout
    if args.lora_rank:
        layout = {"kind": "lora", "rank": args.lora_rank, "seed": args.seed,
                  "base": args.hf_checkpoint or ""}
        if pipe > 1:
            layout["pipeline_stages"] = pipe
        return layout
    if pipe > 1:
        return {"kind": "pipeline", "n_stages": pipe}
    return None


def open_checkpoints(args, model_config, mesh=None):
    """The run's :class:`.checkpoint.TrainCheckpointer` (``None`` without
    ``--checkpoint-dir``) after the reference's refusals: a directory with
    steps and no ``--resume``; a manifest of another model; a manifest
    without a layout record for a run that has one.  A new directory gets
    the manifest.  On a mesh every rank checks (they read the same files)
    and rank 0 alone writes."""
    if not args.checkpoint_dir:
        return None
    if mesh is not None:
        _barrier(mesh)
    from .checkpoint import (
        MODEL_MANIFEST, TrainCheckpointer, load_model_layout,
        load_model_manifest, save_model_manifest,
    )

    checkpointer = TrainCheckpointer(args.checkpoint_dir,
                                     keep=args.checkpoint_keep)
    latest = checkpointer.latest_step()
    if latest is not None and not args.resume:
        raise SystemExit(
            f"checkpoint dir {args.checkpoint_dir} already has step "
            f"{latest}; pass --resume to continue it or use a fresh dir"
        )
    layout = checkpoint_layout(args)
    if (Path(args.checkpoint_dir) / MODEL_MANIFEST).exists():
        prior_family, prior_config = load_model_manifest(args.checkpoint_dir)
        prior_layout = load_model_layout(args.checkpoint_dir)
        hint = ""
        if (prior_layout is None) == (layout is None):
            # the manifest keeps no dtype: compare the architecture
            mismatch = (prior_family, prior_config, prior_layout) != (
                args.family,
                type(model_config)(**{**vars(model_config),
                                      "dtype": prior_config.dtype}),
                layout)
        else:
            # a manifest without a layout record cannot tell a dense run
            # from a pre-layout-record --moe run: refuse with the fix
            mismatch = True
            if layout is not None:
                hint = (
                    "; if this dir WAS trained with these exact flags "
                    "before the layout record existed, add "
                    f'"layout": {json.dumps(layout)} to its '
                    "model_config.json"
                )
        if mismatch:
            raise SystemExit(
                f"checkpoint dir {args.checkpoint_dir} was written by a "
                f"{prior_family} run with {prior_config} "
                f"(layout={prior_layout}); this run's flags describe a "
                f"different model ({args.family}, {model_config}, "
                f"layout={layout}){hint}"
            )
    elif mesh is None or mesh.rank == 0:
        save_model_manifest(args.checkpoint_dir, args.family, model_config,
                            layout=layout)
    if mesh is not None:
        _barrier(mesh)
    return checkpointer


def _barrier(mesh) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def open_mesh(args, device):
    """The run's :class:`.distributed.Mesh`, or ``None`` for a lone process
    without mesh flags.  Joins the process group when launched over ranks
    (:func:`.distributed.initialize_from_env`); a mesh that does not
    divide the ranks exits with the reference's message.  Ranks other than
    0 log only warnings."""
    from .distributed import (
        initialize_from_env, make_mesh, make_topology_mesh,
        make_topology_pipeline_mesh,
    )

    if int(os.environ.get("RANK", "").strip() or 0) != 0:
        logging.getLogger().setLevel(logging.WARNING)
    joined = initialize_from_env(device=device)
    meshed = (args.model_parallel > 1 or args.seq_parallel > 1
              or args.zigzag or args.topology_mesh or args.pipe_parallel > 1)
    if not (joined or meshed):
        return None
    try:
        if args.pipe_parallel > 1:
            from .pipeline import make_pipeline_mesh

            make = (make_topology_pipeline_mesh if args.topology_mesh
                    else make_pipeline_mesh)
            mesh = make(args.pipe_parallel,
                        model_parallel=args.model_parallel,
                        seq_parallel=args.seq_parallel, device=device)
        else:
            make = make_topology_mesh if args.topology_mesh else make_mesh
            mesh = make(model_parallel=args.model_parallel,
                        seq_parallel=args.seq_parallel, device=device)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    micro = args.pipe_microbatches if args.pipe_parallel > 1 else 1
    rows = args.batch_size // micro
    if rows % mesh.shape["data"]:
        what = ("--batch-size / --pipe-microbatches"
                if args.pipe_parallel > 1 else "--batch-size")
        raise SystemExit(
            f"{what} {rows} not divisible by the data axis "
            f"({mesh.shape['data']})")
    log.info("Mesh: %s over %d ranks (%s%s)", mesh.shape, mesh.size,
             mesh.transport.backend,
             ", CUDA tensors staged through host memory"
             if mesh.transport.staged and mesh.device.type == "cuda" else "")
    return mesh


def build_model(args, device, train_config):
    """``(model_config, moe_config, base_params, state)``: the run's model
    and its train state.  A LoRA run's ``state`` is ``None`` (its frozen
    base is ``base_params``); a full run's ``base_params`` is ``None``."""
    from .train import init_train_state, train_state

    d_ff = args.d_ff if args.d_ff is not None else (
        1408 if args.family == "llama" else 2048)
    generator = torch.Generator().manual_seed(args.seed)
    moe_config = None
    if args.moe:
        from .moe import MoeConfig

        moe_config = MoeConfig(n_experts=args.moe_experts,
                               top_k=args.moe_top_k)
    hf_base = None
    if args.family == "llama":
        from . import llama

        if args.hf_checkpoint:
            from .hf_convert import load_hf_llama

            model_config, hf_base = load_hf_llama(args.hf_checkpoint,
                                                  device=device)
            log.info(
                "HF base: %s (d_model=%d layers=%d heads=%d/%d)",
                args.hf_checkpoint, model_config.d_model,
                model_config.n_layers, model_config.n_heads,
                model_config.n_kv_heads,
            )
            if model_config.max_seq_len < args.seq_len:
                raise SystemExit(
                    f"HF model max_seq_len={model_config.max_seq_len} < "
                    f"--seq-len {args.seq_len}"
                )
        else:
            model_config = LlamaConfig(
                vocab_size=args.vocab_size, d_model=args.d_model,
                n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
                n_layers=args.n_layers, d_ff=d_ff, max_seq_len=args.seq_len,
                sliding_window=args.sliding_window or None,
            )
        init_dense = llama.init_llama_params
    else:
        from .model import init_params as init_dense

        model_config = ModelConfig(
            vocab_size=args.vocab_size, d_model=args.d_model,
            n_heads=args.n_heads, n_layers=args.n_layers, d_ff=d_ff,
            max_seq_len=args.seq_len,
        )
    if args.moe:
        from .moe import init_llama_moe_params, init_moe_params

        init_routed = (init_llama_moe_params if args.family == "llama"
                       else init_moe_params)
        base = init_routed(model_config, moe_config, generator, device)
    else:
        base = hf_base if hf_base is not None else init_dense(
            model_config, generator, device)
    if args.pipe_parallel > 1:
        base = stage_stacked(args, model_config, base, hf_base is not None)
    if args.lora_rank:
        # params only: the base is frozen, so no full-model AdamW moments
        return model_config, moe_config, base, None
    return model_config, moe_config, None, train_state(base, train_config)


def stage_stacked(args, model_config, base: dict, from_hf: bool) -> dict:
    """The run's weights in the pipeline's stage-stacked layout, after the
    reference's refusal of a layer count that the stages do not divide."""
    from .pipeline import (
        as_llama_pipeline_params, as_pipeline_params, check_stages,
    )

    pipe = args.pipe_parallel
    if from_hf and model_config.n_layers % pipe:
        raise SystemExit(
            f"HF model has n_layers={model_config.n_layers}, not divisible "
            f"by --pipe-parallel {pipe}"
        )
    try:
        check_stages(model_config.n_layers, pipe)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    stack = (as_llama_pipeline_params if args.family == "llama"
             else as_pipeline_params)
    return stack(base)


def flat_params(params: dict, family: str) -> dict:
    """The flat serving layout of a tree (a stage-stacked one unstacked)."""
    if "stages" not in params:
        return params
    from .pipeline import unstack_layers, unstack_llama_layers

    return (unstack_llama_layers if family == "llama"
            else unstack_layers)(params)


def make_pipeline_step(args, model_config, moe_config, train_config, mesh,
                       lora=None):
    """The run's step through the pipeline (:mod:`.pipeline`): the
    family's objective, zig-zag or routed, on the ``--pipe-schedule``; or
    the adapter-only step on ``lora = (frozen part, LoraConfig)``."""
    from .pipeline import PipelineConfig, make_pipeline_train_step

    pcfg = PipelineConfig(n_microbatches=args.pipe_microbatches,
                          schedule=args.pipe_schedule)
    llama = args.family == "llama"
    try:
        if lora is not None:
            from .lora import make_lora_pipeline_train_step

            frozen, lora_config = lora
            return make_lora_pipeline_train_step(
                mesh, model_config, pcfg, train_config, frozen, lora_config,
                llama=llama, moe=moe_config)
        return make_pipeline_train_step(
            mesh, model_config, pcfg, train_config, llama=llama,
            zigzag=args.zigzag, moe=moe_config)
    except ValueError as err:
        raise SystemExit(str(err)) from None


def make_step(args, model_config, moe_config, train_config, device,
              lora=None, mesh=None):
    """The run's optimizer step: the family's objective (routed with
    ``--moe``) through :func:`.train.make_train_step`, or the adapter-only
    step of :mod:`.lora` on ``lora = (frozen_params, LoraConfig)``.  On a
    mesh: the family's mesh objective, natural-order or zig-zag."""
    from . import llama, moe

    if mesh is not None and "pipe" in mesh.shape:
        return make_pipeline_step(args, model_config, moe_config,
                                  train_config, mesh, lora)
    if mesh is not None:
        from .train import make_train_step

        objective = mesh_objective(args, model_config, moe_config,
                                   train_config, mesh)
        if lora is not None:
            from .lora import make_lora_train_step

            frozen, lora_config = lora
            return make_lora_train_step(model_config, train_config, frozen,
                                        lora_config, device, loss=objective,
                                        mesh=mesh)
        return make_train_step(
            model_config, train_config, device, loss=objective,
            window=getattr(model_config, "sliding_window", None), mesh=mesh)

    objective = None
    if args.moe:
        moe._require_no_remat(train_config)
        routed = (moe.llama_moe_loss_fn if args.family == "llama"
                  else moe.moe_loss_fn)

        def objective(params, tokens, attention_fn):
            return routed(params, tokens, model_config, moe_config,
                          attention_fn)
    elif args.family == "llama":
        objective = llama.llama_mesh_loss(model_config, train_config)
    if lora is not None:
        from .lora import make_lora_train_step

        frozen, lora_config = lora
        return make_lora_train_step(model_config, train_config, frozen,
                                    lora_config, device, loss=objective)
    if args.moe:
        make = (moe.make_llama_moe_train_step if args.family == "llama"
                else moe.make_moe_train_step)
        return make(model_config, moe_config, train_config, device)
    if args.family == "llama":
        return llama.make_llama_train_step(model_config, train_config,
                                           device)
    from .train import make_train_step

    return make_train_step(model_config, train_config, device)


def _family_hidden(family: str):
    """``(forward_fn, readout_fn)`` of the family for the mesh objectives
    (``(None, None)``: the gpt defaults)."""
    if family == "llama":
        from .llama import llama_forward_hidden, readout_weights

        return llama_forward_hidden, readout_weights
    return None, None


def mesh_objective(args, model_config, moe_config, train_config, mesh,
                   aux_weight: float | None = None):
    """The run's objective on a mesh in the train step's loss-seam shape:
    the rank's share of the family's loss, natural-order
    (:func:`.train.mesh_loss`) or zig-zag
    (:func:`.zigzag.make_zigzag_loss`), routed over the mesh with
    ``--moe`` (:func:`.moe.mesh_forward_factory`; ``aux_weight`` 0 drops
    the aux term, for eval)."""
    from .train import mesh_loss

    forward_fn, readout_fn = _family_hidden(args.family)
    factory = None
    if args.moe:
        from .moe import _require_no_remat, mesh_forward_factory

        _require_no_remat(train_config)
        factory = mesh_forward_factory(moe_config, mesh,
                                       args.family == "llama", aux_weight)
        forward_fn = None
    if args.zigzag:
        from .zigzag import make_zigzag_loss

        return make_zigzag_loss(mesh, model_config,
                                remat=train_config.remat,
                                forward_fn=forward_fn, readout_fn=readout_fn,
                                forward_factory=factory)
    return mesh_loss(model_config, mesh, remat=train_config.remat,
                     forward_fn=forward_fn, readout_fn=readout_fn,
                     forward_factory=factory)


def make_mesh_eval(args, model_config, moe_config, mesh, params_of):
    """``eval_loss(state, tokens) -> float`` on a mesh: the rank's share
    of the pure LM loss over its rows (no aux term), summed over the
    ranks."""
    from .data import mesh_rows
    from .train import TrainConfig, mesh_attention_fn

    loss = mesh_objective(args, model_config, moe_config, TrainConfig(),
                          mesh, aux_weight=0.0)
    attend = mesh_attention_fn(
        mesh, getattr(model_config, "sliding_window", None))

    def eval_loss(state, tokens) -> float:
        rows = mesh_rows(tokens, mesh)
        with torch.no_grad():
            value = loss(params_of(state), rows, attend)
        return float(mesh.transport.all_reduce(value.clone(),
                                               mesh.replicas.group))

    return eval_loss


def make_pipeline_eval(args, model_config, moe_config, mesh, params_of):
    """``eval_loss(state, tokens) -> float`` through the pipeline: the
    forward slots alone on the rank's microbatched rows, the pure LM loss
    (no aux term), summed over the ranks."""
    from .pipeline import PipelineConfig, pipeline_loss, pipeline_rows

    pcfg = PipelineConfig(n_microbatches=args.pipe_microbatches)

    def eval_loss(state, tokens) -> float:
        rows = pipeline_rows(tokens, mesh, pcfg.n_microbatches)
        return float(pipeline_loss(
            params_of(state), rows, model_config, pcfg, mesh,
            llama=args.family == "llama", zigzag=args.zigzag,
            moe=moe_config, aux_weight=0.0))

    return eval_loss


def make_eval(args, model_config, moe_config, device, params_of):
    """``eval_loss(state, tokens) -> float``: the pure LM loss with no
    gradient (the aux term of ``--moe`` is a training regularizer, not a
    quality signal); the no-lse flash forward on the card."""
    window = getattr(model_config, "sliding_window", None)
    attend = windowed(attention_fn_for(args.seq_len, device,
                                       model_config.head_dim), window)
    if args.moe:
        from .moe import llama_moe_forward, moe_forward

        forward = (llama_moe_forward if args.family == "llama"
                   else moe_forward)

        def loss(params, tokens):
            logits, _aux = forward(params, tokens, model_config, moe_config,
                                   attend)
            return next_token_nll(logits, tokens)
    elif args.family == "llama":
        from .llama import llama_loss_fn

        def loss(params, tokens):
            return llama_loss_fn(params, tokens, model_config, attend)
    else:
        def loss(params, tokens):
            return loss_fn(params, tokens, model_config, attend)

    def eval_loss(state, tokens) -> float:
        with torch.no_grad():
            return float(loss(params_of(state), tokens))

    return eval_loss


def setup(args) -> dict:
    """The run's pieces from parsed flags: ``device``, ``model_config``,
    ``state`` (the train state, or a LoRA run's adapter state),
    ``step_fn``, ``checkpointer`` (or ``None``), ``save_state`` (the
    in-memory state's checkpointed form), ``params_of`` (the state's
    effective parameters) and, for LoRA, ``lora``."""
    check_args(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    mesh = open_mesh(args, device)
    if mesh is not None:
        device = mesh.device
    train_config = TrainConfig(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, remat=args.remat,
        grad_accum=args.grad_accum, grad_clip_norm=args.grad_clip_norm,
    )
    model_config, moe_config, base, state = build_model(args, device,
                                                        train_config)
    if args.data_dir and args.corpus_vocab > model_config.vocab_size:
        raise SystemExit(
            f"corpus vocab_size={args.corpus_vocab} exceeds the model's "
            f"vocab_size={model_config.vocab_size}"
        )
    from .train import param_leaves

    counted = param_leaves(base if state is None else state["params"])
    log.info("Model: %s parameters on %s",
             f"{sum(t.numel() for t in counted):,}", device)
    pipe = mesh is not None and "pipe" in mesh.shape
    if mesh is not None:
        from .train import _check_divisible

        try:
            _check_divisible(mesh, model_config,
                             moe_config.n_experts if moe_config else None)
        except ValueError as err:
            raise SystemExit(str(err)) from None
    lora = None

    def save_state(s):
        return s

    def params_of(s):
        return s["params"]

    full_params_of = params_of

    if args.lora_rank:
        from .lora import (
            LoraConfig, apply_lora, init_lora_train_state,
            lora_checkpoint_state, lora_param_count,
        )

        lora_config = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha)
        # on a mesh each rank adapts its slices of the frozen base; the
        # adapters are replicated (through a pipeline, sliced by stage)
        frozen = base
        if pipe:
            from .pipeline import shard_pipeline_params

            frozen = shard_pipeline_params(base, mesh)
        elif mesh is not None:
            from .train import shard_params

            frozen = shard_params(base, mesh)
        lora = (frozen, lora_config)
        init_adapters = init_lora_train_state
        if pipe:
            from .lora import init_pipeline_lora_train_state as init_adapters
        state = init_adapters(
            torch.Generator().manual_seed(args.seed + 1), base, lora_config,
            train_config)

        # checkpoints carry the MERGED weights (the worker serves them as
        # any flat checkpoint) and the adapter state a resume restores
        def save_state(s):
            return lora_checkpoint_state(base, s, lora_config)

        def params_of(s):
            return apply_lora(frozen, s["adapters"], lora_config, mesh)

        def full_params_of(s):
            return apply_lora(base, s["adapters"], lora_config)

        if pipe:
            from .lora import (
                apply_pipeline_lora, gather_pipeline_lora_state,
                lora_pipeline_checkpoint_state,
            )

            def save_state(s):
                return lora_pipeline_checkpoint_state(
                    base, gather_pipeline_lora_state(mesh, s), lora_config,
                    llama=args.family == "llama")

            def params_of(s):
                return apply_pipeline_lora(frozen, s["adapters"],
                                           lora_config, mesh)

            def full_params_of(s):
                return flat_params(apply_pipeline_lora(
                    base, gather_pipeline_lora_state(mesh, s)["adapters"],
                    lora_config), args.family)

        log.info("LoRA: rank %d, %s adapter parameters (base frozen)",
                 args.lora_rank,
                 f"{lora_param_count(state['adapters']):,}")
    checkpointer = open_checkpoints(args, model_config, mesh)
    if checkpointer is not None and args.resume:
        latest = checkpointer.latest_step()
        if latest is not None:
            from .checkpoint import OrbaxCheckpointError, exit_refused

            try:
                if args.lora_rank:
                    # adapter-only restore; the frozen base was just
                    # rebuilt from the same seed or HF source
                    checkpointer.restore_lora(state)
                else:
                    checkpointer.restore(state)
            except OrbaxCheckpointError as err:
                exit_refused(err)
            log.info("Resumed from checkpoint step %d", latest)
    if pipe and lora is not None:
        from .lora import place_pipeline_lora_state

        # every rank built (or restored) the same full adapters: keep this
        # rank's stage of them
        state = place_pipeline_lora_state(mesh, state)
    elif pipe:
        from .pipeline import (
            gather_pipeline_params, gather_pipeline_state,
            place_pipeline_state,
        )

        # every rank built (or restored) the same full stage stacks: keep
        # this rank's stage and slices; checkpoints gather them back (the
        # pipeline layout)
        state = place_pipeline_state(mesh, state)

        def save_state(s):
            return gather_pipeline_state(mesh, s)

        def full_params_of(s):
            return flat_params(gather_pipeline_params(s["params"], mesh),
                               args.family)
    elif mesh is not None and lora is None:
        from .train import gather_params, gather_state, place_state

        # every rank built (or restored) the same full state: keep this
        # rank's slices; checkpoints gather the full tensors back
        state = place_state(mesh, state)

        def save_state(s):
            return gather_state(mesh, s)

        def full_params_of(s):
            return gather_params(s["params"], mesh)
    return {
        "device": device, "model_config": model_config,
        "moe_config": moe_config, "state": state,
        "step_fn": make_step(args, model_config, moe_config, train_config,
                             device, lora, mesh),
        "checkpointer": checkpointer, "save_state": save_state,
        "params_of": params_of, "full_params_of": full_params_of,
        "lora": lora, "mesh": mesh,
    }


def token_stream(args, vocab_size: int, seed: int, start_step: int):
    """The run's batches from step ``start_step`` on: the corpus (a pure
    function of (seed, step)) or the synthetic stream (skipping the
    batches a resumed run already consumed)."""
    if args.data_dir:
        return corpus_token_stream(args.data_dir, args.batch_size,
                                   args.seq_len, seed=seed,
                                   start_step=start_step)
    stream = synthetic_token_stream(vocab_size, args.batch_size,
                                    args.seq_len, seed=seed)
    for _ in range(start_step):
        next(stream)
    return stream


def train(args) -> dict:
    """Run the loop; returns ``{"losses": [...], "final_step": int}`` plus
    the final effective ``params`` (a LoRA run's merged) and
    ``steps_per_s``, ``tokens_per_s`` and ``mfu`` over every logged
    interval after the first (``None`` with a single interval; ``mfu`` is
    ``None`` off a known card)."""
    run = setup(args)
    device, model_config = run["device"], run["model_config"]
    state, step_fn = run["state"], run["step_fn"]
    checkpointer, save_state = run["checkpointer"], run["save_state"]
    mesh = run["mesh"]
    # rank 0 alone logs, serves /metrics, traces and writes checkpoints
    lead = mesh is None or mesh.rank == 0

    start_step = state["step"]
    last_saved = start_step if args.resume else None
    eval_loss = eval_data = None
    if args.eval_every > 0 and mesh is not None and "pipe" in mesh.shape:
        eval_loss = make_pipeline_eval(args, model_config, run["moe_config"],
                                       mesh, run["params_of"])
    elif args.eval_every > 0 and mesh is not None:
        eval_loss = make_mesh_eval(args, model_config, run["moe_config"],
                                   mesh, run["params_of"])
    elif args.eval_every > 0:
        eval_loss = make_eval(args, model_config, run["moe_config"], device,
                              run["params_of"])
    if eval_loss is not None:
        # a fixed held-out set from a disjoint seed domain of the source
        eval_stream = token_stream(args, model_config.vocab_size,
                                   args.seed + EVAL_SEED_OFFSET, 0)
        eval_data = [torch.from_numpy(next(eval_stream)).to(device)
                     for _ in range(args.eval_batches)]

    metrics = obs_server = None
    if args.metrics_port and lead:
        from ..obs import ObservabilityServer, WorkloadMetrics

        metrics = WorkloadMetrics()
        obs_server = ObservabilityServer(metrics, port=args.metrics_port)
        obs_server.start()

    # --overfit pins the step-0 batch on resume too
    stream = token_stream(args, model_config.vocab_size, args.seed,
                          0 if args.overfit else start_step)
    if args.overfit:
        stream = itertools.repeat(next(stream))
    if mesh is not None and "pipe" in mesh.shape:
        from .pipeline import prefetch_to_pipeline

        # microbatch-major [M, B / M, S], the data axis splitting B / M
        batches = prefetch_to_pipeline(stream, mesh, args.pipe_microbatches)
    elif mesh is not None:
        from .data import prefetch_to_mesh

        batches = prefetch_to_mesh(stream, mesh)
    else:
        batches = prefetch_to_device(stream, device)
    # MFU is per card: a mesh's step FLOPs spread over its ranks
    step_flops = train_step_flops(model_config, args.batch_size,
                                  args.seq_len) / (mesh.size if mesh else 1)

    losses = []
    timed_steps, timed_s = 0, 0.0  # every logged interval after the first
    log_every = max(1, args.log_every)
    # throughput is per logging interval (float(loss) is the sync point),
    # and the interval holding the first step is excluded: it pays the
    # one-time costs (kernel builds, allocator growth, library set-up)
    interval_start = time.perf_counter()
    interval_steps = 0
    try:
        # --steps bounds the run, so tracing it (when asked) is bounded
        with maybe_trace(args.profile_dir if lead else "", device):
            for local_step in range(args.steps):
                state, loss = step_fn(state, next(batches))
                interval_steps += 1
                step = start_step + local_step + 1
                if (local_step % log_every == 0
                        or local_step == args.steps - 1):
                    loss_value = float(loss)  # sync point, when logging
                    losses.append(loss_value)
                    now = time.perf_counter()
                    rate = ""
                    if local_step > 0:
                        steps_per_s = interval_steps / (now - interval_start)
                        tokens_per_s = (steps_per_s * args.batch_size
                                        * args.seq_len)
                        mfu_value = mfu_of(step_flops, 1.0 / steps_per_s,
                                           device)
                        timed_steps += interval_steps
                        timed_s += now - interval_start
                        rate = f" ({steps_per_s:.2f} steps/s, " \
                               f"{tokens_per_s:.0f} tokens/s" + (
                                   f", {mfu_value:.1%} MFU"
                                   if mfu_value is not None else ""
                               ) + ")"
                        if metrics is not None:
                            metrics.set_gauge(
                                "train_tokens_per_sec", tokens_per_s,
                                "Trainer throughput over the last log "
                                "interval.")
                            metrics.set_gauge(
                                "train_steps_per_sec", steps_per_s,
                                "Optimizer steps per second.")
                            if mfu_value is not None:
                                metrics.set_gauge(
                                    "train_mfu", mfu_value,
                                    "Model FLOPs utilization (per card).")
                    if metrics is not None:
                        metrics.set_gauge("train_loss", loss_value,
                                          "Last logged training loss.")
                        metrics.set_gauge("train_step", step,
                                          "Global optimizer step.")
                    interval_start = now
                    interval_steps = 0
                    log.info("step %d loss %.4f%s", step, loss_value, rate)
                if eval_loss is not None and step % args.eval_every == 0:
                    value = sum(eval_loss(state, tokens)
                                for tokens in eval_data) / len(eval_data)
                    log.info("step %d eval_loss %.4f (%d held-out batches)",
                             step, value, len(eval_data))
                    if metrics is not None:
                        metrics.set_gauge(
                            "eval_loss", value,
                            "Mean loss on the fixed held-out batches.")
                    # eval time is not charged to the training interval
                    interval_start = time.perf_counter()
                    interval_steps = 0
                # checkpoint-every 0 = only the final save below
                if (checkpointer is not None and args.checkpoint_every > 0
                        and step % args.checkpoint_every == 0):
                    # the write streams on a thread while training goes
                    # on; the next save (or the final wait) joins it
                    saved = save_state(state)  # collective on a mesh
                    if lead:
                        checkpointer.save(saved, wait=False)
                    last_saved = step
                    log.info("Checkpointed step %d", step)
        final_step = state["step"]
        needs_final_save = checkpointer is not None and \
            last_saved != final_step
        final_state = (save_state(state)
                       if needs_final_save or args.hf_export else None)
        if needs_final_save and lead:
            checkpointer.save(final_state)
        elif checkpointer is not None and lead:
            checkpointer.wait_until_finished()
        if mesh is not None:
            _barrier(mesh)  # the step is on disk before any rank returns
        if args.hf_export and lead:
            from .hf_convert import save_hf_llama

            save_hf_llama(flat_params(final_state["params"], args.family),
                          model_config, args.hf_export)
            log.info("Exported transformers checkpoint to %s",
                     args.hf_export)
    finally:
        if obs_server is not None:
            obs_server.stop()
    steps_per_s = timed_steps / timed_s if timed_steps else None
    with torch.no_grad():
        params = run["full_params_of"](state)
    return {
        "losses": losses, "final_step": final_step, "params": params,
        "steps_per_s": steps_per_s,
        "tokens_per_s": steps_per_s and steps_per_s * args.batch_size
        * args.seq_len,
        "mfu": steps_per_s and mfu_of(step_flops, 1.0 / steps_per_s, device),
    }


def main(argv=None) -> dict:
    configure_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    refusal = mesh_usage(args)
    if refusal:
        parser.error(refusal)  # exit 2, as a usage error
    return train(args)


if __name__ == "__main__":
    main()
