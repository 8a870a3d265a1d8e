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
9. controller: the port's controller binary (``python -m
   kube_sqs_autoscaler_tpu_torch``) as a child process with the deployment
   manifest's thresholds (poll 1 s, cooldowns 3 s and 6 s, max 3: cut for
   time), polling the SQS emulator's depth (400 generate bodies queued at
   the start) and scaling the Deployment of an in-script apiserver double
   through a JSON kubeconfig; in this process an ``ElasticWorkerPool`` of
   batch ``QueueWorker`` s (the built-in GPT, bf16) reconciles to its
   replicas every 0.5 s over the same wire.  The controller is killed with
   SIGKILL after its first scale-up and started again with the same
   command (``--state-path``); after the drain the double answers the
   first scale-down's PUTs 503 for 3 s; then (b) ``--policy predictive
   --forecaster holt`` and ``--policy learned --policy-checkpoint
   LEARNED_POLICY.json`` (``--device cuda``), each a closed loop of its
   own over 200 bodies, the two side by side: each body answered once, the
   journal's policy block, ``build_info``'s policy label and the durable
   section of each, forecasts past the warm-up and a scale-up, the
   network's up, down or hold depths, each tick's decide span beside the
   reactive loop's.  Gates of the first loop: every body answered once,
   the journal's replica trajectory 1 -> >= 2 -> 1, no scale-up inside its
   cooldown (across the restart too), ``flash_fwd`` launches = 4 x prompt
   batches and no lse, the ``ControllerMetrics`` families on ``/metrics``,
   ``/healthz`` 503 "rehydrating" then 200 with
   ``controller_restarts_total 1``, the breaker closed -> open -> a
   half-open probe -> closed; printed: the drain's time and msgs/s, the
   trajectory, the tick p50s and the kernel's share of the drain;
9b. policies: the forecasters (EWMA, Holt, least squares) on the card
   against their CPU runs on seeded histories (empty to wrapped, at
   epoch-scale clocks) within 1e-5 / 1e-4; ``LEARNED_POLICY.json`` on the
   card (its hash the CPU load's, logits within 1e-5 of the CPU's, the
   same decisions and knob deltas on seeded states); ``SERVING_POLICY.json``
   refused by ``LearnedPolicy``; the host time of one tick of each policy
   and the device work it issues;
10. shards: the sharded serving plane at the generate cell's width, 8
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
11. llama: the binary's built-in llama (``--family llama``, 2 kv heads) in
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
12. int8: the built-in GPT and llama in bf16 with ``--quantize int8``,
   ``--quantize-kv`` and both: codes quantized on the card byte-equal to
   the CPU's, the weight bytes from the binary's log line, the 8-slot int8
   caches (18.0625 MiB GPT, 4.5156 MiB llama); replies identical across
   the batch worker, blocks 1 and 8 and S = 1 with ``n_layers x`` prompt
   passes forward launches; in f32 (int8 weights and cache) the
   staggered prompts through blocks 1 and 8 and a 4-shard plane against
   the port's own int8 generate up to the first near-tie; warm rates and
   peak memory of bf16, int8 weights, int8 cache and both at block 8 and
   ``--shards 4``; a profiled int8 plane;
13. prefix: ``--prefix-ids`` of 37 tokens at both families' full width,
   full-precision and int8 cache, through batch, blocks 1 and 8 and
   ``--shards 4`` (the prefix's ``n_layers`` launches once, the suffix
   inserts none; replies counted against the batch worker's); in f32 the
   staggered suffixes through the block-8 batcher behind the prefix
   against ``generate`` of prefix and suffix joined (the int8 layout
   against its own prefix generate), up to the first near-tie;
14. speculative: ``--speculative-draft-layers 2 --speculative-draft-tokens
   4`` for both families in bf16 through the batch worker
   (``n_layers + draft_layers`` forward launches a batch: the target's
   and the draft's prefill) and ``--continuous`` (``n_layers`` an
   insert: one target prefill seeds both caches), replies counted
   against the plain greedy worker's on the same weights, the accepted
   fraction, rounds a request and second rounds dispatched ahead;
   ``--temperature 0.8`` answering 16 of 16 in the vocabulary; the
   acceptance rule on the card over 10^5 rows of synthetic distributions
   (V = 32), its emitted marginal within total variation 0.01 of the
   warped target; in f32 the staggered prompts through the batch
   ``speculative_generate`` and the slot engine against greedy
   ``generate`` up to the first near-tie; the GPT with ``--quantize-kv``
   and behind the 37-token prefix;
15. beam: ``--beams 4``, and with ``--length-penalty 0.6 --eos-id`` a
   token the demo emits, for both families through the batch worker and
   ``--continuous`` (``n_layers`` launches a prompt pass), replies counted
   between the two; in f32 the beam slots against ``beam_search`` of each
   prompt alone up to the first near-tie in the search's selection; the
   GPT with ``--quantize-kv`` and the prefix; warm rates of plain block-1
   ``--continuous``, speculative and beams; ``torch.profiler`` over a
   beam drain with the parent gather's share;
16. sync: for the GPT and the llama, one ``decode_step``, one
   ``block_decode`` of 8 and one pooled insert of prefix-pool hits under
   ``torch.cuda.set_sync_debug_mode("error")``: no call may wait for the
   card (the GPT's calls through the GELU as it was before its repair are
   printed beside); the repair's gain, timed before, after, after, before
   in this call: the GPT decode step, block-8 ``--demo 64`` msgs/s and the
   flagship train step;
17. tenancy: multi-tenant fair admission and the per-tenant prefix pool
   at both built-in models' full width (``--continuous --decode-block 8
   --prefix-pool 8``, 512-token prefixes and suffixes): the reference's
   flood-isolation traffic on a ``FakeClock`` under DRR and FIFO (exactly
   once, replies labeled with their tenant, completions per tenant, pool
   hits + misses = requests, ``n_layers x installs`` forward launches,
   one insert and one decode dispatch a cycle at most, the victims' mean
   wait lower under DRR); f32 tenant requests through the block-8
   batcher, both families and the GPT's int8 cache, against ``generate``
   of prefix and suffix joined up to the first near-tie, and a quiesced
   row reused with a fresh row's result; an overload episode
   (``--shed-tiers 3``: degrade, evict, shed the flood; no victim shed;
   one reply or error reply each); warm rates and per-tenant TTFT beside
   tenancy off with the prefix prepended (bf16 replies counted); a
   profiled tenancy drain;
18. planes: the serving planes at both models' full width, bf16 (f32 for
   the parity gates): (a) tenancy on a ``--shards 4`` plane under the
   tenancy phase's flood traffic, DRR and FIFO (exactly once, the
   victims' wait lower under DRR, sticky homes held with the spills
   counted, one pool install a (tenant, shard) pair first seen; f32 pooled
   replies against ``generate`` of prefix and suffix joined); (b) the
   GPT's run with ``--admission-shards 4``, the flood's admission shard
   killed mid-flood and another gossip-partitioned (exactly once, its
   staged requests handed back and served, the shard rehydrated); (c)
   speculative rows on the decode plane (``--shards 4
   --speculative-draft-layers 2 --speculative-draft-tokens 4``, 64 bodies,
   drafting turned off mid-drain; f32 equal to plain ``--shards 4`` up to
   the first near-tie); (d) ``DisaggregatedPool`` (2 prefill replicas x 8,
   4 decode shards x 8) against the fused 6 x 8 plane on the reference's
   disaggregation traffic, and with a prefill replica killed mid-handoff
   (exactly once, ``flash_fwd`` launches = ``4 x`` prefill inserts and
   none for the KV handoff, f32 replies identical to the fused plane's);
   msgs/s, tokens/s and mean TTFT of each beside plain ``--shards 4``,
   the handoff's rows, bytes and the time of a batch of 8, and a profiled
   drain's busy share;
19. odd head dim: the trainer at ``--d-model 64 --n-heads 4`` (D = 16)
   through dense attention with no kernel launch, its loss falling; the
   forward wrapper called directly at D = 16 must raise ``ValueError``;
20. training: an f32 loss and gradient at the flagship train width through
   the kernels against the dense-attention path; the trainer binary's code
   path in-process at the flagship config (GPT, d_model 1024, 16 heads,
   8 layers, d_ff 4096, vocab 8192, B=8, S=2048) in bf16 for 10
   ``--overfit`` steps, whose losses must be finite and fall and whose
   lse-forward, dq and dk/dv launch counts must each be ``n_layers x
   steps`` (and twice that for the forward under ``--remat``); its steady
   step time, tokens/s, MFU and peak memory; ``torch.profiler`` over one
   step; the "train kernels" phase also holds the backward at the
   flagship llama shape (16 query heads over 4 kv heads, D = 64, B = 8,
   S = 2048), causal and with a window of 512, against its plain version,
   and times the three training kernels there beside SDPA with
   ``enable_gqa=True``;
21. the rest of training (the "training" phase, bf16): (a) the flagship
   llama cell (vocab 8192, d_model 1024, 16 heads over 4 kv heads, 8
   layers, d_ff 2816, B = 8, S = 2048) through the trainer binary for 10
   ``--overfit`` steps, full causal and with ``--sliding-window 512``:
   the loss falls, the lse forward, dq and dk/dv kernels launch
   ``n_layers`` times a step each; step time, tokens/s, MFU, peak memory
   and a profiled step's busy share; (b) the flagship GPT at 4 layers: 6
   steps against 3 with ``--checkpoint-every 3`` and 3 more with
   ``--resume``, losses equal, then the worker binary's
   ``--checkpoint-dir`` replies equal to serving the resumed run's
   in-memory weights; (c) ``--moe`` (8 experts, top-2) for both
   families, 5 steps: the loss falls, the worker refuses the checkpoint
   with the reference's error; step time and peak memory; (d)
   ``--lora-rank 8`` on the flagship llama: the untargeted weights of the
   merged checkpoint equal the seeded base, every adapter moved, and the
   worker's replies from it equal serving ``merge_lora``; (e) the
   flagship llama through ``hf_state_dict_from_llama`` and
   ``llama_params_from_hf`` bit for bit (and, where ``transformers`` is
   installed, the HF directory round trip at 2 layers and the worker's
   ``--hf-checkpoint``), the worker's text path through a stub tokenizer,
   batch and continuous; (f) ``write_token_shards`` and 5 steps on
   ``--data-dir`` through the native reader, built on first use; (g)
   ``--profile-dir`` (the trace names ``flash_bwd_dq``) and
   ``--metrics-port`` (a mid-run scrape has the train gauges);
22. mesh: sequence and tensor parallelism, 2-4 ranks sharing the card
   (its launch runs beside the ``pipe`` and ``serve mesh`` launches, whose
   ranks also wait on gloo, so their step times and rates are not those of
   a launch alone; the MoE runs take the card one at a time, and the
   kernels are timed once every launch is done)
   (``python -m torch.distributed.run --standalone``, gloo, each hop's and
   collective's tensors staged through pinned host memory, so its times
   are not multi-card numbers): (a) ring and zig-zag attention at ``sp =
   4`` at the flagship attention shape stretched over the ring ((4, 16,
   8192, 64) bf16), at (2, 8, 2048, 64) f32, at the llama's GQA (16 over
   4 kv heads) and with a window of 512, output and q, k, v gradients
   against one process's ``flash_attention`` over the whole sequence, each
   rank's lse, dq and dk/dv launches exactly its live hops (ring ``d +
   1``, zig-zag ``P + 1``); (b) the trainer binary at flagship width, 3
   ``--overfit`` steps each: the GPT cut to 4 layers at S = 8192, B = 4
   with
   ``--seq-parallel 4``, ``--seq-parallel 4 --zigzag`` and
   ``--model-parallel 2 --seq-parallel 2`` (whose checkpoint the
   single-card worker serves, replies equal to serving the gathered
   weights), the llama at S = 4096 with ``--seq-parallel 2
   --sliding-window 512``: the first loss against one process's, falling
   losses, exact per-rank launches, step time and per-rank peak memory;
   (c) the flagship GPT cut to 4 layers for 3 steps with ``--moe
   --seq-parallel 2 --zigzag`` (experts over the data axis) and
   ``--lora-rank 8 --seq-parallel 2``; (d) an orbax-shaped step
   directory refused by the worker and by ``--resume`` (exit 2); then
   the three training kernels at the hop shapes, timed alone;
23. pipe: the trainer's GPipe and 1F1B stages over 4 ranks sharing the
   card (``--pipe-rank``), first two losses against one process's, exact
   launches a rank; the training kernels at the stage shapes;
24. serve mesh: the worker binary with ``--model-parallel 2`` (dp 2 x tp
   2) and ``--model-parallel 4`` over 4 ranks sharing the card
   (``--serve-mesh-rank``): the built-in GPT at full width, batch and
   continuous at block 8 (24 bodies, three fills of the slots), the llama
   at tp 2 (one kv head a rank, 24), one batch of ``--beams 2``, and one
   batch of 8 tokens a reply each of ``--quantize-kv``, ``--prefix-ids``,
   speculative, ``--tenants --prefix-pool``, ``--shards 4`` and classify;
   the fleet: the binary's ``--fleet-max-replicas 3`` over dp 2 x tp 2 (64
   bodies of 8 tokens), the ``fleet`` phase's ``FakeClock`` episode (64
   bodies of 16 tokens, a busy replica killed and another hung) and a
   ``ShardedWorkerPool`` of 4 shards (40 bodies), every rank's trajectory
   and pool events equal one process's;
   every body answered once, by rank 0 alone; bf16 replies against one
   process's, each difference at a near-tie of one process's (top-two
   margin below 2e-2; a beam search's: one process's search, replayed,
   drops or ranks the mesh's reply below its own by less than 2e-2 in
   joint log-probability); each rank's exact forward launches;
   the f32 serving functions and block-8 engine at full width equal to one
   process's, the engine's cache on a rank its 4 rows and 4 heads of one
   process's 8 and 8; rates beside one process's; then the forward
   kernel at the ranks' shapes against its plain version, timed beside
   SDPA and its bound;
25. sims: the simulators, the serving twin and the policy trainers on
   the card (``sim/``, ``learn/``): (a) ``verify_fidelity`` over the
   default battery, reactive, the three forecasters and
   ``LEARNED_POLICY.json`` (0 divergences), every compiled episode batch
   run under ``torch.cuda.set_sync_debug_mode("error")`` (no
   synchronizing call inside an episode); (b) the fluid learn recipe in
   full (the battery and 2 seed-101 variants of each world, population
   32, 40 generations): the committed reward curve to 6 decimals, theta
   and hash ``09f88697cfea``; (c) ``verify_twin_fidelity`` over
   ``default_twin_battery(cycles=240)``, reactive and
   ``SERVING_POLICY.json``, the real plane at the built-in GPT's width in
   bf16 (0 divergences; forward launches equal to the layers times the
   plane's attention inserts: plain and resume inserts and prefix-pool
   installs); (d) the serving recipe's first :data:`SIMS_SERVING_GENS`
   generations against ``SERVING_POLICY.json``'s curve; (e) the four
   demos, each exiting 0.  Each part's wall time, and one profiled batch's
   kernel launches and device busy share; then the forward kernel at the
   twin's insert shapes against its plain version, timed beside SDPA and
   its bound.  The phase runs in this process while the ``mesh``,
   ``pipe`` and ``serve mesh`` launches run (printed inside ``mesh``), so
   its times are not those of the phase alone;
26. a JSON line ``{"kernels": [...]}`` with each kernel's numbers;
27. the last line, ``{"ok": true, "device": {...}}``.

The binary runs of the llama, int8, prefix, speculative and beam phases
serve 16 bodies (two batches, two fills of the slots) and their f32 checks
take every other one of the 24 ragged prompts; the mesh and pipe trainer
runs take 3 steps: depth cut so that the run stays inside its 1200 s
limit on the slower hosts.  A phase is not started once less than a
minute of that limit is left.  Every process the run starts is stopped
when it ends, on SIGTERM, SIGINT or SIGHUP too, and the ranks of a launch
exit of themselves once the run's own process is gone.

It needs one card, imports nothing of JAX, and exits non-zero without a
card or outside a checkout of the repository.

``python3 chip_smoke.py --repair-cost PARENT`` measures instead what a
change to the model's numerics costs: for the checkout at ``PARENT`` and
this one, in the order parent, this, this, parent, each in a process of
its own, the operators a decode step of 8 rows dispatches, the GPT decode
step's time, and the flagship trainer's steady step time and peak
memory.

The whole run's ``decode attn`` phase holds the cached decode attention
kernel (``csrc/decode_attn.cu``) to its plain version in f32 at the
benchmark cells' shapes and others, each row of each head to its own
scale, beside a control the same limit must refuse (the answer with one
key off); times it; and runs each family's drain, and beam, speculative
and sharded-plane replies, through it against the plain path.  Every
serving path decodes through it, and the kernels line gives its launches
by phase (and by run of the serving mesh's ranks).
``python3 chip_smoke.py --decode-attn`` runs the device and build phases
and that phase alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import re
import shutil
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
# the flagship llama train cell (the JAX package's workbench llama cell):
# 16 query heads over 4 kv heads at D = 64, d_ff 2816, B = 8, S = 2048
LLAMA_TRAIN_ARGS = ["--family", "llama", "--vocab-size", "8192",
                    "--d-model", "1024", "--n-heads", "16", "--n-kv-heads",
                    "4", "--n-layers", "8", "--d-ff", "2816", "--seq-len",
                    "2048", "--batch-size", "8", "--device", "cuda"]
LLAMA_TRAIN_DIMS = dict(vocab_size=8192, d_model=1024, n_heads=16,
                        n_kv_heads=4, n_layers=8, d_ff=2816)
LLAMA_TRAIN_SHAPE = (8, 16, 4, 2048, 64)  # (B, H, H_kv, S, D)
LLAMA_TRAIN_WINDOW = 512
# the checkpoint, corpus and profile runs: the flagship GPT cut to 4 layers
SHORT_TRAIN_ARGS = [*TRAIN_ARGS[:4], "--n-layers", "4", *TRAIN_ARGS[6:]]
SHORT_TRAIN_LAYERS = 4
MAIN_SHAPES = [(8, 8, 512, 64), (8, 8, 1024, 64)]  # generate, classify
# the sharded plane's prompt passes: a refill of 4 shards x 8 slots, and
# resume inserts of 1 and 8 evacuated rows (512 prompt + 32 produced)
PLANE_SHAPES = [(32, 8, 512, 64), (1, 8, 544, 64), (8, 8, 544, 64)]
# the shared prefix's one prompt pass: 37 tokens, no multiple of the tiles
PREFIX_SHAPES = [(1, 8, 37, 64)]
# the tenant prefix pool's install prefill: one 512-token prefix
POOL_SHAPES = [(1, 8, 512, 64)]
GENERATE_ARGS = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
                 "--generate-tokens", "32", "--result-queue-url",
                 "demo://replies"]
CLASSIFY_ARGS = ["--demo", "16", "--batch-size", "8", "--seq-len", "1024",
                 "--result-queue-url", "demo://replies"]
# the gated binary runs of the llama, int8, prefix, speculative and beam
# phases: two batches of 8, two fills of the engine's 8 slots (cut from 64
# for the run's time limit; the main path's phases keep 64)
GATE_BODIES = 16
# the ragged f32 prompts of those phases' parity checks: every other one of
# staggered_requests()'s 24 (7 to 512 tokens), cut for the same reason
GATE_STAGGER = slice(None, None, 2)
# the run's time limit; a phase is not started once less than a minute of
# it is left, so the run fails on its own instead of being killed
RUN_LIMIT_S = 1200
LAST_START_S = RUN_LIMIT_S - 60
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


def decode_attention_count() -> int:
    """The cached decode attention kernel's launches in this process so far
    (0 before its module is imported)."""
    module = sys.modules.get(
        "kube_sqs_autoscaler_tpu_torch.workloads.decode_attn")
    return 0 if module is None else module.decode_attention_launches


class Smoke:
    def __init__(self) -> None:
        self.failures: list[str] = []
        self.start = time.perf_counter()
        #: the decode attention kernel's launches in this process by phase,
        #: counted from just before the phase; a nested phase's launches
        #: count in its own entry only
        self.decode_launches: dict[str, int] = {}
        self._nested: list[int] = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok    " if ok else "FAIL  ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name: str, fn, *args):
        """Run one phase; an exception fails the run (after the other
        phases have run) and is printed, never swallowed.  Past
        :data:`LAST_START_S` of the run the phase fails unstarted."""
        print(f"== {name}", flush=True)
        start = time.perf_counter()
        if start - self.start > LAST_START_S:
            self.check(False, f"phase {name} not started: "
                       f"{start - self.start:.1f} s of the run's "
                       f"{RUN_LIMIT_S} s gone")
            return None
        before = decode_attention_count()
        self._nested.append(0)
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            self.failures.append(f"phase {name} raised")
            return None
        finally:
            launched = decode_attention_count() - before
            own = launched - self._nested.pop()
            if self._nested:
                self._nested[-1] += launched
            if own:
                self.decode_launches[name] = own
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
    for shape in (*MAIN_SHAPES, *PLANE_SHAPES, *PREFIX_SHAPES,
                  *POOL_SHAPES):
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
    count, name)``, kernels sorted by time.  Device events only: operator
    rows repeat their kernels' time.  Copies are listed apart: the trace
    may also hold copies made before the window.  Summed from the raw
    trace events: ``key_averages`` builds an event object a kernel, tens
    of seconds for a drain's hundred thousand launches."""
    totals: dict[str, list] = {}
    for event in prof.profiler.kineto_results.events():
        if "CUDA" not in str(event.device_type()):
            continue
        row = totals.setdefault(event.name(), [0.0, 0])
        row[0] += event.duration_ns() / 1e6
        row[1] += 1
    kernels, copies = [], []
    for name, (ms, count) in totals.items():
        if ms > 0:
            is_copy = name.startswith(("Memcpy", "Memset"))
            (copies if is_copy else kernels).append((ms, count, name))
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


def demo64(args: list[str], bodies: int = 64) -> list[str]:
    args = list(args)
    args[args.index("--demo") + 1] = str(bodies)
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


def staggered_drive(batcher, requests, every: int = 3,
                    flip: dict | None = None):
    """Submit ``requests`` at most 3 at a time every ``every`` cycles while
    the others decode, until all finish; returns ``(tokens by request,
    cycles)``.  ``flip`` (``{"after": n}``, a decode plane): drafting is
    turned off for new admissions once ``n`` requests are admitted, and
    the drafted rows still in flight then are recorded under
    ``"drafted_in_flight"``."""
    waiting, got, cycle = list(enumerate(requests)), {}, 0
    while (waiting or batcher.active) and cycle < 5000:
        free = len(batcher.free_slots)
        if waiting and free and cycle % every == 0:
            if flip is not None and "drafted_in_flight" not in flip \
                    and len(requests) - len(waiting) >= flip["after"]:
                batcher.set_speculative(False)
                flip["drafted_in_flight"] = sum(
                    spec and slot.busy
                    for spec, slot in zip(batcher._slot_spec, batcher.slots))
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
        # the flagship llama train cell: 16 query heads over 4 kv heads at
        # D = 64, as the model hands them over, full causal and windowed
        ("llama-gqa-h16-kv4-d64", *LLAMA_TRAIN_SHAPE[:3],
         LLAMA_TRAIN_SHAPE[3], LLAMA_TRAIN_SHAPE[3], LLAMA_TRAIN_SHAPE[4],
         True, None, 0, True, False),
        (f"llama-gqa-h16-kv4-d64-window{LLAMA_TRAIN_WINDOW}",
         *LLAMA_TRAIN_SHAPE[:3], LLAMA_TRAIN_SHAPE[3], LLAMA_TRAIN_SHAPE[3],
         LLAMA_TRAIN_SHAPE[4], True, LLAMA_TRAIN_WINDOW, 0, True, False),
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
    llama = {f"window{w}" if w else "causal": llama_train_timing(
        torch, flash, F, w) for w in (None, LLAMA_TRAIN_WINDOW)}
    return {"errs": errs, "timings": timings, "llama_timings": llama}


def llama_train_timing(torch, flash, F, window) -> dict:
    """The three training kernels at the flagship llama shape (16 query
    heads over 4 kv heads, D = 64, bf16), timed beside their plain
    versions and SDPA with ``enable_gqa=True`` (forward alone, and its
    backward alone for dq and dk/dv together; a window passes its mask),
    with their bounds."""
    b, h, hkv, s, d = LLAMA_TRAIN_SHAPE
    q, k, v, dout = train_inputs(torch, b, h, hkv, s, s, d, torch.bfloat16,
                                 True, 97)
    opts = dict(window=window)
    out, lse = flash.flash_fwd_reference(q, k, v, **opts)
    args = (q, k, v, dout, lse, flash.attention_delta(out, dout))
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, dout))
    mask = dict(is_causal=True)
    call = "F.scaled_dot_product_attention(enable_gqa=True)"
    if window is not None:
        rows = torch.arange(s, device="cuda")[:, None]
        cols = torch.arange(s, device="cuda")[None, :]
        mask = dict(attn_mask=(cols <= rows) & (cols > rows - window))
        call += " with a window mask"
    qg, kg, vg = (t.clone().requires_grad_() for t in (qc, kc, vc))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True,
                                              **mask)

    def sdpa_backward():
        torch.autograd.grad(sdpa_out, (qg, kg, vg), doc, retain_graph=True)

    sdpa_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, enable_gqa=True, **mask))
    sdpa_bwd_ms = time_ms(torch, sdpa_backward)
    timings = {
        "flash_fwd_lse": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_fwd(
                q, k, v, need_lse=True, **opts)),
            plain_ms=time_ms(torch, lambda: flash.flash_fwd_reference(
                q, k, v, **opts)),
            library_ms=sdpa_fwd_ms, library_call=call + " forward",
            kind="fwd_lse"),
        "flash_bwd_dq": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_bwd_dq(
                *args, **opts)),
            plain_ms=time_ms(torch, lambda: flash.flash_bwd_dq_reference(
                *args, **opts)),
            library_ms=sdpa_bwd_ms,
            library_call=call + " backward alone (dq, dk and dv together)",
            kind="dq"),
        "flash_bwd_dkv": dict(
            kernel_ms=time_ms(torch, lambda: flash.flash_bwd_dkv(
                *args, **opts)),
            plain_ms=time_ms(torch, lambda: flash.flash_bwd_dkv_reference(
                *args, **opts)),
            library_ms=sdpa_bwd_ms,
            library_call=call + " backward alone (dq, dk and dv together)",
            kind="dkv"),
    }
    for name, t in timings.items():
        kind = t.pop("kind")
        t["bound_ms"], t["bound_by"] = flash_bound_ms(
            (b, h, s, d), hkv, "bfloat16", window=window, kind=kind)
        t["tflops"] = flash_ops((b, h, s, d), window=window,
                                kind=kind) / t["kernel_ms"] / 1e9
        print(f"time {name} bf16 GQA {LLAMA_TRAIN_SHAPE} window={window}: "
              f"kernel {t['kernel_ms']:.4f} ms ({t['tflops']:.1f} TFLOP/s), "
              f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} "
              f"ms ({t['library_call']}), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})", flush=True)
    return timings


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
# Every process the run starts inherits RUN_MARK in its environment, and
# the ranks of a launch also their launch's LAUNCH_MARK: the run finds them
# by it, orphans of a killed launcher included (torch.distributed.run puts
# each rank in a session of its own).  OWNER_PID is the run's own process.
RUN_MARK = "CHIP_SMOKE_RUN"
LAUNCH_MARK = "CHIP_SMOKE_LAUNCH"
OWNER_PID = "CHIP_SMOKE_PID"


def marked_pids(key: str, value: str) -> list[int]:
    """The live processes other than this one whose environment holds
    ``key=value``."""
    needle = f"{key}={value}".encode()
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as fh:
                if needle in fh.read().split(b"\0"):
                    found.append(int(entry))
        except OSError:
            continue
    return found


def stop_marked(key: str, value: str) -> int:
    """SIGKILL every process marked ``key=value`` until none is left (one
    may fork between a scan and the kill); returns how many there were."""
    import signal

    stopped = set()
    for _ in range(10):
        pids = marked_pids(key, value)
        if not pids:
            break
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        stopped.update(pids)
        time.sleep(0.1)
    return len(stopped)


def exit_with_owner() -> None:
    """In a rank: exit at once when the run's own process is gone (killed,
    so it could not stop its launches itself)."""
    owner = int(os.environ.get(OWNER_PID, "0"))
    if not owner:
        return

    def watch() -> None:
        while True:
            try:
                with open(f"/proc/{owner}/stat") as fh:
                    state = fh.read().rsplit(")", 1)[1].split()[0]
            except (OSError, IndexError):
                state = "X"
            if state in ("Z", "X"):
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=watch, daemon=True).start()


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


def fleet_gates():
    """The binary's fleet gates: poll 0.1 s, up at 2 x 8 messages, down at
    8, cooldowns 0.2 and 0.4 s."""
    from kube_sqs_autoscaler_tpu_torch.core import PolicyConfig

    return PolicyConfig(scale_up_messages=2 * 8, scale_down_messages=8,
                        scale_up_cooldown=0.2, scale_down_cooldown=0.4)


def flat_params(params) -> list:
    if isinstance(params, dict):
        return [t for v in params.values() for t in flat_params(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in flat_params(v)]
    return [params]


def fleet_episode(torch, params, config, device="cuda", driver_cls=None,
                  observer=None, knobs=None, on_cycle=None, mesh=None,
                  bodies=64, tokens=32, depth_policy=None,
                  knob_policy=None, kill=FLEET_KILL,
                  hang=FLEET_HANG) -> dict:
    """The deterministic fleet episode on one ``FakeClock``: the
    ``--demo 64`` traffic, ``WorkerPool.serving(min=1, max=3)`` at
    ``--batch-size 8 --seq-len 512 --generate-tokens 32 --decode-block
    8``, the binary's control loop (poll 0.1 s, up at 2 x 8 messages,
    down at 8, cooldowns 0.2 and 0.4 s), two fleet cycles a poll, and a
    fault plan that kills replica 1 and hangs replica 2 while they hold
    requests.  Runs until every request is answered and the fleet is back
    at min.  ``driver_cls`` replaces ``FleetDriver`` (the event
    scheduler's ``ScheduledFleetDriver``), ``observer`` sees the loop's
    tick records, ``knobs(pool, clock)`` returns a ``KnobActuator`` armed
    on the pool, and ``on_cycle(cycle, pool, actuator)`` runs with the
    fault plan, before the cycle's knob safe point.  On a serving ``mesh``
    (the rank's) the pool's replicas are mesh workers and the loop reads
    the depth of world rank 0's queue; ``bodies`` and ``tokens`` cut the
    traffic; ``depth_policy`` (also the loop's tick observer) and
    ``knob_policy`` (``knob_policy(actuator)``, for the event scheduler's
    driver) put a learned brain on the loop and the knobs."""
    from kube_sqs_autoscaler_tpu_torch.core import (
        ControlLoop, FakeClock, LoopConfig,
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
            for body in demo_bodies(bodies, config.vocab_size)]
    service_config = ServiceConfig(
        queue_url=FLEET_QUEUE, batch_size=8, seq_len=512,
        generate_tokens=tokens, decode_block=8,
        result_queue_url=FLEET_RESULTS)
    pool = WorkerPool.serving(queue, params, config, service_config,
                              result_queue=results, min=1, max=3,
                              clock=clock, device=device, mesh=mesh)
    depth = queue
    if mesh is not None:
        from kube_sqs_autoscaler_tpu_torch.workloads.distributed import (
            RankQueue,
        )

        depth = RankQueue(queue)
    if depth_policy is not None:
        from kube_sqs_autoscaler_tpu_torch.core.events import MultiObserver

        observer = (depth_policy if observer is None
                    else MultiObserver([depth_policy, observer]))
    loop = ControlLoop(
        pool,
        QueueMetricSource(depth, FLEET_QUEUE, ("ApproximateNumberOfMessages",)),
        LoopConfig(poll_interval=0.1, policy=fleet_gates()),
        clock=clock, observer=observer, depth_policy=depth_policy)
    plan = FleetFaultPlan(kills=(kill,) if kill else (),
                          hangs=(hang,) if hang else ())
    actuator = knobs(pool, clock) if knobs is not None else None
    busy_at_fault = {}

    class Recorded:
        """The plan, noting how many requests each target holds when its
        fault lands."""

        def apply(self, cycle, target):
            for at, index in (f for f in (kill, hang) if f):
                if at == cycle:
                    busy_at_fault[index] = \
                        target._member(index).worker.batcher.active
            plan.apply(cycle, target)
            if on_cycle is not None:
                on_cycle(cycle, target, actuator)

    extra = {} if actuator is None else {"knobs": actuator}
    if knob_policy is not None:
        extra["knob_policy"] = knob_policy(actuator)
    driver = (driver_cls or FleetDriver)(
        pool, loop, cycle_dt=0.05, fault_plan=Recorded(), **extra)
    stats = driver.run(max_cycles=3000, until=lambda: (
        pool.processed >= len(sent) and pool.idle
        and pool.replicas == pool.min
        and not any(r.state == DRAINING for r in pool.members)))
    return {"pool": pool, "stats": stats, "sent": sent,
            "replies": drain_raw(results, FLEET_RESULTS),
            "busy_at_fault": busy_at_fault, "queue": queue,
            "actuator": actuator}


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


# The controller phase: the port's controller binary as a child process
# scales an ElasticWorkerPool of batch workers in this process through a
# Kubernetes apiserver double and the SQS emulator.  The deployment
# manifest's thresholds (deploy/kube-sqs-autoscaler.yaml:32-38); times cut
# for the phase's budget (manifest: poll 5s, up 5m, down 30s, max 5).
CONTROLLER_ARGS = [
    "--poll-period=1s", "--scale-up-cool-down=3s",
    "--scale-down-cool-down=6s", "--scale-up-messages=100",
    "--scale-down-messages=10", "--scale-up-pods=1", "--scale-down-pods=1",
    "--max-pods=3", "--min-pods=1",
    "--attribute-names=ApproximateNumberOfMessages",
    "--scaler-retries=1", "--breaker-failures=2", "--breaker-reset=2s",
]
CONTROLLER_BODIES = 400  # four times the scale-up threshold
CONTROLLER_UP_COOLDOWN = 3.0
CONTROLLER_MAX = 3
CONTROLLER_OUTAGE_S = 3.0  # the apiserver double's 503 window for PUTs
# two ticks are a poll period (1 s) apart; a PUT's arrival trails its
# gate by the GET's round trip, so gaps are compared to the cooldown less
# this much (a fire inside the cooldown would show as a gap of <= 2 s)
CONTROLLER_GAP_SLACK = 0.25
CONTROLLER_DEPLOYMENT = "workers"


class DeploymentDouble:
    """The apps/v1 Deployment endpoints of an apiserver on 127.0.0.1: GET
    and full-object PUT of one Deployment in ``default``, with a
    ``resourceVersion`` that every write bumps (a PUT carrying a stale one
    gets 409 Conflict).  From the first PUT that lowers the replicas, PUTs
    are answered 503 for ``outage_s`` seconds: the phase's fault window.
    Every request is logged as ``(t, method, status, replicas)`` on
    ``time.monotonic``."""

    def __init__(self, replicas: int, outage_s: float) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.lock = threading.Lock()
        self.replicas = replicas
        self.version = 1
        self.outage_s = outage_s
        self.outage_from = None
        self.log: list[tuple[float, str, int, int]] = []
        double = self
        path = ("/apis/apps/v1/namespaces/default/deployments/"
                f"{CONTROLLER_DEPLOYMENT}")

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                if self.path != path:
                    return self._reply(404, {"kind": "Status", "code": 404})
                with double.lock:
                    body = double.body()
                    double.note("GET", 200, double.replicas)
                self._reply(200, body)

            def do_PUT(self) -> None:  # noqa: N802 (http.server API)
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if self.path != path:
                    return self._reply(404, {"kind": "Status", "code": 404})
                want = int(body["spec"]["replicas"])
                with double.lock:
                    now = time.monotonic()
                    if double.outage_from is None and want < double.replicas:
                        double.outage_from = now
                    if (double.outage_from is not None and now
                            < double.outage_from + double.outage_s):
                        double.note("PUT", 503, want)
                        status, reply = 503, {
                            "kind": "Status", "code": 503,
                            "message": "apiserver unavailable (fault window)"}
                    elif body["metadata"].get("resourceVersion") != str(
                            double.version):
                        double.note("PUT", 409, want)
                        status, reply = 409, {
                            "kind": "Status", "code": 409,
                            "message": "the object has been modified"}
                    else:
                        double.replicas = want
                        double.version += 1
                        double.note("PUT", 200, want)
                        status, reply = 200, double.body()
                self._reply(status, reply)

            def log_message(self, *args) -> None:
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def body(self) -> dict:
        return {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": CONTROLLER_DEPLOYMENT,
                         "namespace": "default",
                         "resourceVersion": str(self.version)},
            "spec": {"replicas": self.replicas,
                     "selector": {"matchLabels": {"app": "worker"}}},
        }

    def note(self, method: str, status: int, replicas: int) -> None:
        self.log.append((time.monotonic(), method, status, replicas))

    def writes(self) -> list[tuple[float, int]]:
        """``(t, replicas)`` of every successful PUT."""
        with self.lock:
            return [(t, r) for t, m, s, r in self.log
                    if m == "PUT" and s == 200]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def http_get(url: str, timeout: float = 5.0) -> tuple[int, str]:
    """``(status, body)`` of a GET; an HTTP error status is an answer."""
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def wait_for(predicate, timeout: float, every: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return predicate()


def journal_trajectory(episodes, start: int = 1, low: int = 1,
                       high: int = CONTROLLER_MAX) -> list[int]:
    """The replica count after each journaled tick, replayed from the
    ticks' successful actuations (a boundary no-op clamps, as the scaler
    does), from ``start`` replicas."""
    replicas, out = start, []
    for _, records in episodes:
        for record in records:
            if record.scaled("up"):
                replicas = min(high, replicas + 1)
            if record.scaled("down"):
                replicas = max(low, replicas - 1)
            out.append(replicas)
    return out


class ControllerRun:
    """One boot of the port's controller binary as a child process, its
    output in ``build/chip_smoke/controller-<n>.log``."""

    def __init__(self, argv: list[str], env: dict, n: int) -> None:
        self.log = ROOT / "build" / "chip_smoke" / f"controller-{n}.log"
        self.log.parent.mkdir(parents=True, exist_ok=True)
        self.fh = open(self.log, "w")
        self.child = subprocess.Popen(
            [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch", *argv],
            cwd=ROOT, env=env, stdout=self.fh, stderr=subprocess.STDOUT)

    def stop(self, kill: bool = False) -> int:
        if self.child.poll() is None:
            self.child.kill() if kill else self.child.terminate()
        try:
            self.child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.child.kill()
            self.child.wait()
        self.fh.close()
        return self.child.returncode

    def tail(self) -> str:
        self.fh.flush()
        return self.log.read_text()[-2000:]


def controller_phase(torch, flash, smoke: Smoke, kern) -> dict:
    """The port's controller binary closing the loop on port workers on
    the card: ``CONTROLLER_BODIES`` bodies queued at the start; the
    controller (``python -m kube_sqs_autoscaler_tpu_torch``) polls the SQS
    emulator's depth and scales the apiserver double's Deployment; in this
    process an ``ElasticWorkerPool`` of ``QueueWorker`` s (the built-in GPT,
    bf16, batch 8, ``--seq-len 512 --generate-tokens 32``, one set of
    weights) reconciles to its replicas every 0.5 s over the same wire.
    Mid-drain the controller is killed with SIGKILL and started again
    with the same command (``--state-path``); after the drain the double
    answers the first scale-down's PUTs 503 for ``CONTROLLER_OUTAGE_S``
    seconds, which opens the circuit breaker."""
    import shutil

    from kube_sqs_autoscaler_tpu_torch.metrics.sqs_aws import AwsSqsService
    from kube_sqs_autoscaler_tpu_torch.obs.journal import (
        read_journal_episodes,
    )
    from kube_sqs_autoscaler_tpu_torch.scale.kube import (
        ClusterConfig,
        KubeDeploymentAPI,
    )
    from kube_sqs_autoscaler_tpu_torch.utils.sigv4 import Credentials
    from kube_sqs_autoscaler_tpu_torch.workloads import kernels
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        ElasticWorkerPool,
        QueueWorker,
        ServiceConfig,
    )

    kernels.build_all()  # no worker thread waits on nvcc
    config, params, _ = demo_setup(torch, GENERATE_ARGS)
    work = ROOT / "build" / "chip_smoke" / "controller"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    emulator = SqsEmulator()
    # the queue's 30 s visibility timeout is a hundred worker cycles
    jobs_url, jobs = emulator.queue("000000000000/jobs")
    replies_url, replies = emulator.queue("000000000000/replies")
    sent = [jobs.send_message(jobs_url, body)
            for body in demo_bodies(CONTROLLER_BODIES)]
    double = DeploymentDouble(replicas=1, outage_s=CONTROLLER_OUTAGE_S)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "chip",
        "contexts": [{"name": "chip",
                      "context": {"cluster": "double", "user": "smoke"}}],
        "clusters": [{"name": "double", "cluster": {"server": double.url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke-token"}}],
    }))
    env = {**os.environ, **LOCAL_AWS_ENV,
           "KUBE_CONFIG_PATH": str(kubeconfig)}
    journal, state = work / "journal.jsonl", work / "state.json"
    port = free_port()
    argv = [*CONTROLLER_ARGS, "--sqs-queue-url", jobs_url, "--aws-region",
            "us-east-1", "--kubernetes-deployment", CONTROLLER_DEPLOYMENT,
            "--kubernetes-namespace", "default", "--metrics-port",
            str(port), "--journal-path", str(journal), "--state-path",
            str(state), "--request-trace", "64"]
    service_config = ServiceConfig(
        queue_url=jobs_url, batch_size=8, seq_len=512, generate_tokens=32,
        result_queue_url=replies_url, idle_sleep_s=0.05)
    built: list = []

    class CountedWorker(QueueWorker):
        """A batch worker that counts the prompt batches it ran."""

        batches = 0

        def run_once(self) -> int:
            n = super().run_once()
            self.batches += n > 0
            return n

    credentials = Credentials(LOCAL_AWS_ENV["AWS_ACCESS_KEY_ID"],
                              LOCAL_AWS_ENV["AWS_SECRET_ACCESS_KEY"])

    def factory():
        client = AwsSqsService(region="us-east-1", credentials=credentials)
        worker = CountedWorker(client, params, config, service_config,
                               result_queue=client, device="cuda")
        built.append(worker)
        return worker

    api = KubeDeploymentAPI("default", config=ClusterConfig(server=double.url))
    pool = ElasticWorkerPool(api, CONTROLLER_DEPLOYMENT, factory)
    t0 = time.monotonic()
    workers_seen: list[tuple[float, int]] = []
    done = threading.Event()

    def reconcile():  # the kubelet's role, every 0.5 s
        while not done.is_set():
            try:
                n = pool.reconcile()
            except Exception as err:
                print(f"reconcile failed: {err}", flush=True)
            else:
                if not workers_seen or workers_seen[-1][1] != n:
                    workers_seen.append((time.monotonic() - t0, n))
            done.wait(0.5)

    def depth() -> dict:
        return jobs.get_queue_attributes(jobs_url, ())

    def answered() -> int:
        return int(replies.get_queue_attributes(
            replies_url, ())["ApproximateNumberOfMessages"])

    zero_counts(flash)
    boots = [ControllerRun(argv, env, 1)]
    kubelet = threading.Thread(target=reconcile, daemon=True)
    kubelet.start()
    out: dict = {}
    health: list[tuple[float, int, str]] = []
    try:
        # mid-drain: SIGKILL half a second after the first scale-up landed
        up = wait_for(lambda: any(r >= 2 for _, r in double.writes()), 90)
        time.sleep(0.5)
        kill_depth = depth()
        kill_t = time.monotonic() - t0
        killed = boots[0].stop(kill=True)
        smoke.check(up and killed == -9
                    and int(kill_depth["ApproximateNumberOfMessages"]) > 0,
                    f"controller: first scale-up landed, SIGKILL at "
                    f"{kill_t:.3f} s with {kill_depth} queued (exit "
                    f"{killed}; log {boots[0].log.relative_to(ROOT)}: "
                    f"{'...' if up else boots[0].tail()})")
        boots.append(ControllerRun(argv, env, 2))

        def probe() -> bool:
            try:
                status, body = http_get(
                    f"http://127.0.0.1:{port}/healthz", timeout=2)
            except OSError:
                return False  # not listening yet
            health.append((time.monotonic() - t0, status, body.strip()))
            return status == 200

        healthy = wait_for(probe, 30)
        first = health[0] if health else None
        _, scrape = http_get(f"http://127.0.0.1:{port}/metrics")
        smoke.check(healthy and first is not None and first[1] == 503
                    and first[2].startswith("rehydrating")
                    and "kube_sqs_autoscaler_controller_restarts_total 1\n"
                    in scrape,
                    f"controller restart: /healthz answered {first} first, "
                    f"then 200 after {len(health)} probes "
                    f"({health[-1][0] if health else None} s); "
                    f"controller_restarts_total 1 on /metrics: "
                    f"{'controller_restarts_total 1' in scrape}")
        # the drain, then the scale-down through the fault window to min
        drained = wait_for(lambda: answered() >= CONTROLLER_BODIES
                           and depth()["ApproximateNumberOfMessages"] == "0"
                           and depth()[
                               "ApproximateNumberOfMessagesNotVisible"] == "0",
                           180)
        drain_s = time.monotonic() - t0
        back = wait_for(lambda: double.outage_from is not None
                        and time.monotonic() > double.outage_from
                        + CONTROLLER_OUTAGE_S and double.replicas == 1, 90)
        time.sleep(1.5)  # one more tick after the last scale-down
        _, scrape = http_get(f"http://127.0.0.1:{port}/metrics")
        _, trace = http_get(f"http://127.0.0.1:{port}/debug/trace")
        requests_status, requests_body = http_get(
            f"http://127.0.0.1:{port}/debug/requests?n=8&slo=1")
        alive = boots[1].child.poll() is None
        smoke.check(drained and back and alive,
                    f"controller: drained {answered()} of "
                    f"{CONTROLLER_BODIES} in {drain_s:.3f} s, back to "
                    f"{double.replicas} replica(s), boot 2 alive {alive} "
                    f"(log {boots[1].log.relative_to(ROOT)}: "
                    f"{'...' if drained and back and alive else boots[1].tail()})")
    finally:
        done.set()
        kubelet.join(timeout=10)
        stopped = [boot.stop() for boot in boots[1:]]
        pool.stop_all()
        torch.cuda.synchronize()
        launched = counts(flash)
        attrs = depth()
        got = drain_raw(replies, replies_url)
        emulator.close()
        double.close()
    smoke.check(stopped == [0], f"controller: boot 2 exited {stopped} on "
                f"SIGTERM")
    duplicates = sum(len(bodies) - 1 for bodies in got.values())
    smoke.check(sorted(got) == sorted(sent) and duplicates == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
                f"controller: {len(got)} of {len(sent)} bodies answered, "
                f"{duplicates} duplicates, queue at the end {attrs}")
    batches = sum(w.batches for w in built)
    smoke.check(launched["flash_fwd"] == 4 * batches
                and launched["flash_fwd_lse"] == 0 and batches > 0,
                f"controller: flash_fwd launches {launched['flash_fwd']} = "
                f"4 x {batches} prompt batches of {len(built)} workers, lse "
                f"{launched['flash_fwd_lse']}")
    families = ["ticks_total", "observations_total", "scale_events_total",
                "scale_failures_total", "retries_total", "breaker_state",
                "consecutive_scale_failures", "controller_restarts_total",
                "tick_duration_seconds_bucket", "build_info"]
    missing = [f for f in families
               if f"kube_sqs_autoscaler_{f}" not in scrape]
    smoke.check(not missing and '"name":"restart-rehydrated"' in trace,
                f"controller /metrics: missing families {missing}; "
                f"/debug/trace names restart-rehydrated: "
                f"{'restart-rehydrated' in trace}")
    try:
        snapshot = json.loads(requests_body)
        trace_ok = isinstance(json.loads(trace).get("traceEvents"), list)
    except (ValueError, AttributeError):
        snapshot, trace_ok = {}, False
    smoke.check(requests_status == 200 and trace_ok
                and {"epoch", "open", "replies", "requests",
                     "attribution"} <= set(snapshot),
                f"controller --request-trace 64: /debug/requests answered "
                f"{requests_status} with a snapshot that parses (epoch "
                f"{snapshot.get('epoch')}: the registry came back through "
                f"the durable state); /debug/trace parses: {trace_ok}")

    episodes = read_journal_episodes(str(journal))
    records = [r for _, rs in episodes for r in rs]
    trajectory = journal_trajectory(episodes)
    writes = double.writes()
    smoke.check(len(episodes) == 2 and trajectory and max(trajectory) >= 2
                and trajectory[-1] == 1 and trajectory[-1] == double.replicas
                and [r for _, r in writes][-1:] == [1],
                f"controller trajectory (journal, {len(records)} ticks in "
                f"{len(episodes)} boots): {trajectory}; the double's writes "
                f"{[(round(t - t0, 3), r) for t, r in writes]}")
    ups = [t for (t, r), (_, before) in zip(writes, [(0, 1), *writes])
           if r > before]
    gaps = [b - a for a, b in zip(ups, ups[1:])]
    kill_abs = t0 + kill_t
    before_kill = [t for t in ups if t < kill_abs]
    after_kill = [t for t in ups if t > kill_abs]
    restart_gap = (after_kill[0] - before_kill[-1]
                   if before_kill and after_kill else None)
    smoke.check(all(g >= CONTROLLER_UP_COOLDOWN - CONTROLLER_GAP_SLACK
                    for g in gaps),
                f"controller: no scale-up inside the {CONTROLLER_UP_COOLDOWN}"
                f" s cooldown: gaps between scale-ups {gaps} s; the first "
                f"after the restart {restart_gap} s after the last before it")
    states = [r.breaker_state for r in episodes[-1][1]]
    opened = states.index("open") if "open" in states else None
    rejected = [r for r in episodes[-1][1]
                if "circuit breaker open" in (r.down_error or "")
                or "circuit breaker open" in (r.up_error or "")]
    probe_at = next((i for i in range(opened or 0, len(states))
                     if opened is not None and states[i] == "closed"), None)
    probe = episodes[-1][1][probe_at] if probe_at is not None else None
    failed_puts = [t for t, m, s, _ in double.log if m == "PUT" and s == 503]
    smoke.check(opened is not None and "closed" in states[:opened]
                and bool(rejected) and probe is not None
                and (probe.scaled("down") or probe.scaled("up"))
                and bool(failed_puts),
                f"controller fault window: {len(failed_puts)} PUTs answered "
                f"503; breaker closed -> open (tick {opened}) -> "
                f"{len(rejected)} tick(s) rejected while open -> half-open "
                f"probe (tick {probe_at}, scaled "
                f"{probe and (probe.scaled('down') or probe.scaled('up'))}) "
                f"-> closed; retries {sum(r.scaler_retries or 0 for r in records)}")
    spans = {name: [getattr(r, f) for r in records
                    if getattr(r, f) is not None]
             for name, f in (("observe", "observe_s"), ("decide", "decide_s"),
                             ("actuate", "actuate_s"))}
    p50 = {name: float(np.median(v)) * 1e3 if v else None
           for name, v in spans.items()}
    rate = CONTROLLER_BODIES / drain_s
    timing = (kern or {}).get("timings", {}).get(MAIN_SHAPES[0])
    busy = (launched["flash_fwd"] * timing["kernel_ms"] / (drain_s * 1e3)
            if timing else None)
    print(f"controller drain: {CONTROLLER_BODIES} bodies in {drain_s:.3f} s "
          f"({rate:.3f} msgs/s over {len(built)} workers built); replica "
          f"trajectory (t s, replicas) "
          f"{[(round(t - t0, 3), r) for t, r in writes]}; worker threads "
          f"{[(round(t, 3), n) for t, n in workers_seen]}", flush=True)
    print(f"controller tick p50 ms: observe {p50['observe']}, decide "
          f"{p50['decide']}, actuate {p50['actuate']} "
          f"({len(records)} ticks)", flush=True)
    print(f"controller: flash_fwd busy share of the drain "
          f"{'not measured' if busy is None else f'{100 * busy:.3f}%'} "
          f"(launches x the kernel's timed ms at {MAIN_SHAPES[0]} over the "
          f"drain's wall)", flush=True)
    start = time.perf_counter()
    policies = controller_policies(torch, flash, smoke, config, params,
                                   p50["decide"])
    print(f"-- controller policies: {time.perf_counter() - start:.3f} s",
          flush=True)
    return {"launches": launched["flash_fwd"], "batches": batches,
            "policies": policies,
            "drain_s": drain_s, "msgs_per_s": rate, "tick_p50_ms": p50,
            "trajectory": [(t - t0, r) for t, r in writes],
            "journal_trajectory": trajectory, "busy_share": busy,
            "kill_t": kill_t, "health": health[:3] + health[-1:],
            "restart_gap_s": restart_gap}


# The controller's other policies (controller (b)), each a closed loop of
# its own on the same doubles, the two side by side: POLICY_BODIES bodies,
# the gates of CONTROLLER_ARGS, until the queue is drained and two more
# ticks have run
POLICY_BODIES = 200
CONTROLLER_POLICIES = {
    "predictive": ["--policy", "predictive", "--forecaster", "holt",
                   "--forecast-horizon", "10s"],
    "learned": ["--policy", "learned", "--policy-checkpoint",
                str(ROOT / "LEARNED_POLICY.json")],
}


def policy_loop(torch, config, params, name: str, flags: list[str],
                n: int, device: str = "cuda") -> dict:
    """One closed loop of the controller binary with ``flags`` (``--policy
    ...``, on the card) against its own SQS emulator and apiserver double,
    an ``ElasticWorkerPool`` of batch workers reconciling to it; stops two
    ticks after the drain.  Returns what the gates read."""
    from kube_sqs_autoscaler_tpu_torch.metrics.sqs_aws import AwsSqsService
    from kube_sqs_autoscaler_tpu_torch.obs.journal import (
        read_journal_episodes,
    )
    from kube_sqs_autoscaler_tpu_torch.scale.kube import (
        ClusterConfig, KubeDeploymentAPI,
    )
    from kube_sqs_autoscaler_tpu_torch.utils.sigv4 import Credentials
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        ElasticWorkerPool, QueueWorker, ServiceConfig,
    )

    work = ROOT / "build" / "chip_smoke" / f"controller-{name}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    emulator = SqsEmulator()
    jobs_url, jobs = emulator.queue("000000000000/jobs")
    replies_url, replies = emulator.queue("000000000000/replies")
    sent = [jobs.send_message(jobs_url, body)
            for body in demo_bodies(POLICY_BODIES)]
    double = DeploymentDouble(replicas=1, outage_s=0.0)
    kubeconfig = work / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "chip",
        "contexts": [{"name": "chip",
                      "context": {"cluster": "double", "user": "smoke"}}],
        "clusters": [{"name": "double", "cluster": {"server": double.url}}],
        "users": [{"name": "smoke", "user": {"token": "smoke-token"}}],
    }))
    journal, state, port = work / "journal.jsonl", work / "state.json", \
        free_port()
    argv = [*CONTROLLER_ARGS, "--sqs-queue-url", jobs_url, "--aws-region",
            "us-east-1", "--kubernetes-deployment", CONTROLLER_DEPLOYMENT,
            "--metrics-port", str(port), "--journal-path", str(journal),
            "--state-path", str(state), *flags, "--device", device]
    credentials = Credentials(LOCAL_AWS_ENV["AWS_ACCESS_KEY_ID"],
                              LOCAL_AWS_ENV["AWS_SECRET_ACCESS_KEY"])
    built: list = []

    def factory():
        client = AwsSqsService(region="us-east-1", credentials=credentials)
        worker = QueueWorker(client, params, config, ServiceConfig(
            queue_url=jobs_url, batch_size=8, seq_len=512,
            generate_tokens=32, result_queue_url=replies_url,
            idle_sleep_s=0.05), result_queue=client, device=device)
        built.append(worker)
        return worker

    pool = ElasticWorkerPool(KubeDeploymentAPI(
        "default", config=ClusterConfig(server=double.url)),
        CONTROLLER_DEPLOYMENT, factory)
    done = threading.Event()

    def reconcile():
        while not done.is_set():
            try:
                pool.reconcile()
            except Exception as err:
                print(f"reconcile failed: {err}", flush=True)
            done.wait(0.5)

    def answered() -> int:
        return int(replies.get_queue_attributes(
            replies_url, ())["ApproximateNumberOfMessages"])

    t0 = time.monotonic()
    boot = ControllerRun(argv, {**os.environ, **LOCAL_AWS_ENV,
                                "KUBE_CONFIG_PATH": str(kubeconfig)}, n)
    kubelet = threading.Thread(target=reconcile, daemon=True)

    def ticked() -> bool:
        try:
            return any(records for _, records in
                       read_journal_episodes(str(journal)))
        except (OSError, ValueError):
            return False

    try:
        # the workers start once the controller has ticked: its start-up
        # (torch and the card's context) must not drain the backlog first
        started = wait_for(ticked, 60, every=0.1)
        kubelet.start()
        drained = started and wait_for(
            lambda: answered() >= POLICY_BODIES, 120)
        drain_s = time.monotonic() - t0
        time.sleep(2.2)  # two more ticks
        _, scrape = http_get(f"http://127.0.0.1:{port}/metrics")
    finally:
        done.set()
        if kubelet.is_alive():
            kubelet.join(timeout=10)
        stopped = boot.stop()
        pool.stop_all()
        if device == "cuda":
            torch.cuda.synchronize()
        attrs = jobs.get_queue_attributes(jobs_url, ())
        got = drain_raw(replies, replies_url)
        emulator.close()
        double.close()
    return {"sent": sent, "got": got, "attrs": attrs, "drained": drained,
            "drain_s": drain_s, "stopped": stopped, "scrape": scrape,
            "episodes": read_journal_episodes(str(journal)),
            "state": json.loads(state.read_text()) if state.exists() else {},
            "writes": [(t - t0, r) for t, r in double.writes()],
            "workers": len(built), "log": boot}


def controller_policies(torch, flash, smoke: Smoke, config, params,
                        reactive_decide_ms, device: str = "cuda") -> dict:
    """(b) ``--policy predictive --forecaster holt`` and ``--policy
    learned --policy-checkpoint LEARNED_POLICY.json``, side by side, each
    its own closed loop: every body answered once; the journal's policy
    block, ``build_info``'s policy label and the durable section of each;
    the predictive loop forecasts past its warm-up and scales up, the
    learned one thresholds on its network's up, down or hold depth; the
    decide span of a tick (the policy's forecast or forward on the card)
    beside the reactive loop's."""
    from kube_sqs_autoscaler_tpu_torch.learn import load_checkpoint

    learned = load_checkpoint(str(ROOT / "LEARNED_POLICY.json"),
                              device=device)
    runs: dict = {}
    zero_counts(flash)

    def run(name, n):
        runs[name] = policy_loop(torch, config, params, name,
                                 CONTROLLER_POLICIES[name], n, device)

    threads = [threading.Thread(target=run, args=(name, 3 + i))
               for i, name in enumerate(CONTROLLER_POLICIES)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    launched = counts(flash)
    out = {"launches": launched["flash_fwd"]}
    labels = {"predictive": ('policy="predictive"', 'forecaster="holt"'),
              "learned": (f'policy="learned@{learned.hash}"',)}
    sections = {"predictive": "forecast-history",
                "learned": "learned-mirror"}
    hold = (100 + 10) // 2
    for name, r in runs.items():
        duplicates = sum(len(b) - 1 for b in r["got"].values())
        smoke.check(
            r["drained"] and sorted(r["got"]) == sorted(r["sent"])
            and duplicates == 0 and r["stopped"] == 0
            and r["attrs"]["ApproximateNumberOfMessages"] == "0",
            f"controller --policy {name}: {len(r['got'])} of {len(r['sent'])}"
            f" answered once in {r['drain_s']:.3f} s, exit {r['stopped']} on"
            f" SIGTERM (log {r['log'].log.relative_to(ROOT)})")
        meta = r["episodes"][0][0] if r["episodes"] else {}
        records = [x for _, rs in r["episodes"] for x in rs]
        trajectory = journal_trajectory(r["episodes"])
        block = (meta.get("forecast") if name == "predictive"
                 else meta.get("learn", {}))
        smoke.check(
            meta.get("policy") == name
            and all(label in r["scrape"] for label in labels[name])
            and sections[name] in r["state"].get("sections", {})
            and (block == {"forecaster": "holt", "horizon": 10.0,
                           "history": 128} if name == "predictive"
                 else block.get("checkpoint_hash") == learned.hash),
            f"controller --policy {name}: journal policy block {block}, "
            f"build_info {labels[name]}, durable section {sections[name]}")
        if name == "predictive":
            forecasts = [x.predicted_messages for x in records
                         if x.predicted_messages is not None]
            smoke.check(bool(forecasts) and max(trajectory, default=1) >= 2,
                        f"controller --policy predictive: {len(forecasts)} of "
                        f"{len(records)} ticks forecast ({forecasts[:6]}...); "
                        f"replicas at most {max(trajectory, default=1)}")
        else:
            warm = [x.decision_messages for x in records[3:]]
            smoke.check(bool(warm) and set(warm) <= {100, 10, hold},
                        f"controller --policy learned: the network's depths "
                        f"after the warm-up {sorted(set(warm))} (up 100, down "
                        f"10, hold {hold}); replicas at most "
                        f"{max(trajectory, default=1)}")
        decide = [x.decide_s for x in records[3:] if x.decide_s is not None]
        p50 = float(np.median(decide)) * 1e3 if decide else None
        out[name] = {"writes": r["writes"], "drain_s": r["drain_s"],
                     "decide_p50_ms": p50, "ticks": len(records)}
        print(f"controller --policy {name}: decide span p50 {p50} ms over "
              f"{len(decide)} warm ticks (the reactive loop's "
              f"{reactive_decide_ms} ms; two loops side by side on the "
              f"card); replica writes (t s, replicas) "
              f"{[(round(t, 3), n) for t, n in r['writes']]}", flush=True)
    smoke.check(launched["flash_fwd"] > 0 and launched["flash_fwd_lse"] == 0,
                f"controller policies: flash_fwd launches "
                f"{launched['flash_fwd']} over both loops' prompt batches, "
                f"lse {launched['flash_fwd_lse']}")
    return out


# the policies phase: seeded ring histories (capacity, samples, clock
# epoch): empty, one and two samples, partly filled, full, wrapped twice at
# the monotonic clock of a host up for years
POLICY_HISTORIES = [(128, 0, 0.0), (128, 1, 0.0), (128, 2, 3e5),
                    (128, 77, 3e5), (128, 128, 0.0), (128, 300, 2.7e8),
                    (64, 200, 2.7e8)]
POLICY_RTOL, POLICY_ATOL = 1e-5, 1e-4  # tests/test_torch_forecast.py's
POLICY_LOGIT_TOL = 1e-5  # tests/test_torch_learn.py's
POLICY_TICKS = 50


def policy_history(capacity: int, samples: int, epoch: float, seed: int):
    """A seeded queue-depth walk (drift, noise, the poll's jitter) in a
    ``DepthHistory``."""
    from kube_sqs_autoscaler_tpu_torch.forecast import DepthHistory

    rng = np.random.default_rng(seed)
    history = DepthHistory(capacity)
    t, depth = epoch, float(rng.integers(0, 2000))
    drift = float(rng.normal(0.0, 10.0))
    for _ in range(samples):
        t += float(rng.uniform(4.5, 5.5))
        depth = max(0.0, depth + drift + float(rng.normal(0.0, 20.0)))
        history.observe(t, float(round(depth)))
    return history


def tick_cost(torch, tick, device: str) -> dict:
    """One tick's cost: host ms a tick (median of :data:`POLICY_TICKS`,
    each ending in the read of its result), and the device work a tick
    issues (kernels and copies, from ``torch.profiler`` over ten ticks: a
    profile can miss a few of its first events, so one tick alone would
    undercount)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        tick()
    times = []
    for _ in range(POLICY_TICKS):
        start = time.perf_counter()
        tick()
        times.append((time.perf_counter() - start) * 1e3)
    launches = None
    if device == "cuda":
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                tick()
            torch.cuda.synchronize()
        kernels, copies = device_breakdown(prof)
        launches = {"kernels": sum(c for _, c, _ in kernels) / 10,
                    "copies": sum(c for _, c, _ in copies) / 10,
                    "device_ms": sum(ms for ms, _, _ in kernels + copies)
                    / 10}
    return {"ms": float(np.median(times)), "launches": launches}


def policy_phase(torch, smoke: Smoke, power: str, device="cuda") -> dict:
    """The controller's forecasting and learned policies on the card
    (``forecast/``, ``learn/``): (a) each forecaster on the card against
    its CPU run on seeded histories (empty to wrapped, epoch-scale clocks)
    within the tests' tolerance; (b) ``LEARNED_POLICY.json`` on the card:
    its hash the CPU load's, ``policy_logits`` within 1e-5 of the CPU's
    and the same decisions on seeded states, a knob-headed network's knob
    deltas too; ``SERVING_POLICY.json`` refused by ``LearnedPolicy`` (a
    serving-twin checkpoint); (c) a tick of each policy (reactive, each
    forecaster at a full ring of 128, the learned network at its ring of
    64, with and without the knob head): host ms and the device work it
    issues."""
    from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig
    from kube_sqs_autoscaler_tpu_torch.forecast import (
        DepthHistory, PredictivePolicy, ReactivePolicy, make_forecaster,
    )
    from kube_sqs_autoscaler_tpu_torch.forecast.forecasters import (
        snapshot_tensors,
    )
    from kube_sqs_autoscaler_tpu_torch.learn import (
        CheckpointError, LearnedPolicy, PolicyCheckpoint, init_params,
        load_checkpoint,
    )
    from kube_sqs_autoscaler_tpu_torch.learn.network import (
        learned_decision, policy_features, policy_logits,
    )

    out: dict = {}
    worst = 0.0
    for name in ("ewma", "holt", "lstsq"):
        card, cpu = (make_forecaster(name, device=device),
                     make_forecaster(name, device="cpu"))
        for seed, (capacity, samples, epoch) in enumerate(POLICY_HISTORIES):
            snap = policy_history(capacity, samples, epoch, seed).snapshot()
            for horizon in (0.0, 30.0, 117.0):
                got, want = (card.predict(*snap, horizon),
                             cpu.predict(*snap, horizon))
                worst = max(worst, abs(got - want)
                            / (POLICY_ATOL + POLICY_RTOL * abs(want)))
    smoke.check(worst <= 1.0,
                f"policies (a): ewma, holt and lstsq on the {device} "
                f"against their CPU runs over {len(POLICY_HISTORIES)} "
                f"histories x 3 horizons: worst |d| {worst:.3f} of rtol "
                f"{POLICY_RTOL:g} / atol {POLICY_ATOL:g}")
    out["forecast_worst"] = worst
    path = str(ROOT / "LEARNED_POLICY.json")
    card, cpu = (load_checkpoint(path, device=device),
                 load_checkpoint(path, device="cpu"))
    knob = PolicyCheckpoint(theta=init_params(9, 16, knob_head=True),
                            hidden=16, knob_head=True)
    knob_card = PolicyCheckpoint(theta=knob.theta.to(device), hidden=16,
                                 knob_head=True)
    rng = np.random.default_rng(0)
    logit_err, same, states = 0.0, 0, 64
    for i in range(states):
        history = policy_history(64, int(rng.integers(3, 200)), 2.7e8, i)
        times, depths, n = history.snapshot()
        state = (n, int(rng.integers(0, 400)), int(rng.integers(1, 6)),
                 float(rng.uniform()), float(rng.uniform()), 100)
        for ck, ck_cpu in ((card, cpu), (knob_card, knob)):
            got, want = [], []
            for theta, dev, out_list in ((ck.theta, device, got),
                                         (ck_cpu.theta, "cpu", want)):
                t, d = snapshot_tensors(times, depths, n, dev)
                features = policy_features(t, d, *state, 5, 5.0, 0.3, 12)
                out_list.append(policy_logits(theta, features, ck.hidden,
                                              ck.knob_head).cpu())
                out_list.append(learned_decision(
                    theta, t, d, *state, 10, 55, 3, 5, 5.0, 0.3, 12,
                    hidden=ck.hidden, knob_head=ck.knob_head))
            logit_err = max(logit_err,
                            float((got[0] - want[0]).abs().max()))
            same += got[1] == want[1] and bool(
                got[0].argmax() == want[0].argmax()) and bool(
                got[0][3:].argmax() == want[0][3:].argmax()
                if ck.knob_head else True)
    smoke.check(card.hash == cpu.hash and logit_err <= POLICY_LOGIT_TOL
                and same == 2 * states,
                f"policies (b): LEARNED_POLICY.json on the {device} (hash "
                f"{card.hash}, the CPU load's {cpu.hash}) and a knob-headed "
                f"network: logits within {logit_err:.3e} of the CPU's (tol "
                f"{POLICY_LOGIT_TOL:g}), decisions and knob deltas equal on "
                f"{same} of {2 * states} seeded states")
    serving = load_checkpoint(str(ROOT / "SERVING_POLICY.json"),
                              device=device)
    try:
        LearnedPolicy(serving, policy=PolicyConfig(), poll_interval=5.0,
                      max_pods=5)
        refused = None
    except CheckpointError as err:
        refused = str(err)
    smoke.check(refused is not None and "'serving' twin" in refused,
                f"policies (b): SERVING_POLICY.json ({serving.hash}, a "
                f"serving-twin checkpoint without a knob head) refused by "
                f"LearnedPolicy: {refused}")
    config = PolicyConfig()

    def ticker(policy):
        history = policy_history(policy.history.capacity, 300, 2.7e8, 5)
        policy.history = history
        now = history.snapshot()[0][-1] + 5.0
        return lambda: policy.effective_messages(now, 150)

    ticks = {"reactive": lambda: ReactivePolicy().effective_messages(0.0,
                                                                     150)}
    for name in ("ewma", "holt", "lstsq"):
        ticks[f"predictive-{name}"] = ticker(PredictivePolicy(
            make_forecaster(name, device=device), DepthHistory(128)))
    for label, ck in (("learned", card), ("learned-knob-head", knob_card)):
        ticks[label] = ticker(LearnedPolicy(
            ck, policy=config, poll_interval=5.0, max_pods=5,
            history=DepthHistory(64)))
    out["ticks"] = {}
    for label, tick in ticks.items():
        cost = out["ticks"][label] = tick_cost(torch, tick, device)
        print(f"policies (c) tick {label}: {cost['ms']:.4f} ms on the host "
              f"(median of {POLICY_TICKS}, result read back), device work a "
              f"tick {cost['launches']} ({power})", flush=True)
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


def plane_worker(torch, params, config, service_config, shards,
                 bodies: int = 64, **kw):
    """A continuous worker over the sharded plane, the ``--demo 64`` (or
    ``bodies``) bodies queued."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )

    queue = FakeMessageQueue()
    for body in demo_bodies(bodies):
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
        ControlLoop, FakeClock, LoopConfig,
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
        LoopConfig(poll_interval=0.1, policy=fleet_gates()), clock=clock)
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
    shape: (a) the binary's ``--demo 16`` through the batch worker and
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
        summary = worker([*demo64(args, GATE_BODIES), "--device", "cuda"])
        torch.cuda.synchronize()
        launched = counts(flash)
        replies[mode] = {rid: json.dumps(body) for rid, body in
                         summary["replies"].items()}
        attrs = summary["queue_attributes"]
        smoke.check(summary["processed"] == GATE_BODIES
                    and len(replies[mode]) == GATE_BODIES
                    and summary["duplicate_replies"] == 0
                    and attrs["ApproximateNumberOfMessages"] == "0"
                    and attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
                    and all(len(r.get("tokens", ())) == 32
                            and all(0 <= t < 8192 for t in r["tokens"])
                            for r in summary["replies"].values()),
                    f"llama {mode}: processed {summary['processed']} of "
                    f"{GATE_BODIES}, "
                    f"{len(replies[mode])} replies of 32 tokens in the "
                    f"vocabulary, {summary['duplicate_replies']} duplicates, "
                    f"queue {attrs}")
        # the batch worker prefills once a batch of 8, the engine once an
        # insert of 8: 2 prompt passes of 4 layers either way
        passes = (summary["insert_dispatches"] if mode != "generate"
                  else GATE_BODIES // 8)
        smoke.check(passes == GATE_BODIES // 8
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
        smoke.check(same == GATE_BODIES, f"llama {mode}: {same} of "
                    f"{GATE_BODIES} replies "
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
                          family="llama", bodies=GATE_BODIES)
    zero_counts(flash)
    one.drain(total=GATE_BODIES)
    torch.cuda.synchronize()
    launched = counts(flash)
    plane_replies = {rid: bodies[0] for rid, bodies in
                     drain_raw(results, "demo://replies").items()}
    inserts = one.batcher.insert_dispatches
    same = sum(plane_replies.get(r) == b for r, b in single.items())
    smoke.check(same == GATE_BODIES and one.batcher.family == "llama"
                and launched["flash_fwd"] == LLAMA_LAYERS * inserts
                and launched["flash_fwd_lse"] == 0,
                f"llama S=1 plane bf16 block 8: {same} of {GATE_BODIES} "
                f"replies "
                f"byte-identical to the block-8 worker's; flash_fwd launches "
                f"{launched['flash_fwd']} = {LLAMA_LAYERS} x {inserts} "
                f"inserts, lse {launched['flash_fwd_lse']}")
    out["launches"]["serve-llama-s1"] = launched["flash_fwd"]
    del one

    # (d) the binary's --shards 4 and --fleet-max-replicas 3
    for name, extra in (("shards-4", ["--shards", "4"]),
                        ("fleet-3", ["--fleet-max-replicas", "3"])):
        zero_counts(flash)
        summary = worker([*demo64(LLAMA_ARGS, GATE_BODIES), "--continuous",
                          "--decode-block", "8", *extra, "--device", "cuda"])
        torch.cuda.synchronize()
        launched = counts(flash)
        inserts = summary["insert_dispatches"]
        smoke.check(summary["processed"] == GATE_BODIES
                    and len(summary["replies"]) == GATE_BODIES
                    and summary["duplicate_replies"] == 0
                    and launched["flash_fwd"] == LLAMA_LAYERS * inserts
                    and launched["flash_fwd_lse"] == 0,
                    f"llama binary {name}: processed {summary['processed']} "
                    f"of {GATE_BODIES}, {len(summary['replies'])} replies, "
                    f"{summary['duplicate_replies']} duplicates; flash_fwd "
                    f"launches {launched['flash_fwd']} = {LLAMA_LAYERS} x "
                    f"{inserts} inserts, lse {launched['flash_fwd_lse']}")
        same = sum(json.dumps(body) == single.get(rid)
                   for rid, body in summary["replies"].items())
        print(f"llama binary {name}: {same} of {GATE_BODIES} replies "
              f"byte-identical to "
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
    """Warm ``--demo 32`` rates of the GPT and the llama one after the
    other, for the batch worker, block 8 and ``--shards 4`` (32 bodies: the
    depth cut for time)."""
    rates = {}
    for name, extra in (("batch", []),
                        ("block-8", ["--continuous", "--decode-block", "8"]),
                        ("shards-4", ["--continuous", "--decode-block", "8",
                                      "--shards", "4"])):
        for family in ("gpt", "llama"):
            summary = worker([*demo64(GENERATE_ARGS, 32), *extra,
                              "--family", family, "--device", "cuda"])
            ttft = summary.get("ttft_mean_s") or summary["cycle"]["mean_s"]
            rates[f"{family}-{name}"] = {
                "msgs_per_s": summary["msgs_per_s"],
                "tokens_per_s": summary["tokens_per_s"],
                "ttft_mean_s": ttft, "elapsed_s": summary["elapsed_s"]}
            print(f"warm {family} {name} --demo 32: "
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


def run_binary(torch, flash, worker, args: list[str],
               demo: int = GATE_BODIES):
    """One ``--demo 16`` (or ``demo``) run of the worker binary on the card: (summary,
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
        argv = demo64(args)
        argv[argv.index("--demo") + 1] = str(demo)
        summary = worker([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    return (summary, counts(flash), torch.cuda.max_memory_allocated() - base,
            logs.lines)


def replies_of(summary) -> dict:
    return {rid: json.dumps(body) for rid, body in
            summary["replies"].items()}


def check_served(smoke, label, summary, eos_id=None) -> None:
    """All :data:`GATE_BODIES` answered once and deleted, each reply 32
    tokens in the vocabulary (with ``eos_id``: at most 32, cut before the
    eos)."""
    attrs = summary["queue_attributes"]
    smoke.check(summary["processed"] == GATE_BODIES
                and len(summary["replies"]) == GATE_BODIES
                and summary["duplicate_replies"] == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
                and all((len(r.get("tokens", ())) == 32 if eos_id is None
                         else len(r.get("tokens", ())) <= 32
                         and eos_id not in r["tokens"])
                        and all(0 <= t < 8192 for t in r["tokens"])
                        for r in summary["replies"].values()),
                f"{label}: processed {summary['processed']} of "
                f"{GATE_BODIES}, "
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
                          result_queue=results, sharded=True, family=family,
                          bodies=GATE_BODIES)
    zero_counts(flash)
    one.drain(total=GATE_BODIES)
    torch.cuda.synchronize()
    launched = counts(flash)
    replies = {rid: bodies[0] for rid, bodies in
               drain_raw(results, "demo://replies").items()}
    return replies, launched["flash_fwd"], one.batcher.insert_dispatches


def int8_phase(torch, flash, smoke: Smoke) -> dict:
    """int8 serving at the built-in GPT's and llama's full width in bf16:
    (a) codes on the card equal to the CPU's and the 8-slot caches' bytes;
    (b) the binary's ``--demo 16`` with ``--quantize int8``,
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
                          else GATE_BODIES // 8)
                smoke.check(passes == GATE_BODIES // 8
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
            smoke.check(all(n == GATE_BODIES for n in same.values()),
                        f"{family} {variant}: replies byte-identical to the "
                        f"batch worker's (bf16, greedy), of {GATE_BODIES}: "
                        f"{same}")
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
    requests = staggered_requests()[GATE_STAGGER]
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
                len(got) == len(requests) and not bad
                and launched == 4 * batcher.insert_dispatches,
                f"int8 {family} f32 {name} (int8 weights and cache): "
                f"{len(got)} of {len(requests)} staggered requests in "
                f"{cycles} cycles, "
                f"{batcher.insert_dispatches} inserts ({launched} flash_fwd "
                f"launches); tokens equal to the port's int8 generate alone "
                f"up to the first near-tie (margin < {MARGIN:g}): mismatched "
                f"{bad}; near-ties (request: position) {ties}")
            out[f"{family}-{name}"] = {"mismatched": bad, "near_ties": ties}
            del batcher
        del params
    return out


INT8_RATE_DEMO = 16  # cut from 64 for the run's time limit


def int8_rates(torch, flash, worker) -> dict:
    """Warm ``--demo 16`` rates and peak memory of bf16, int8 weights, the
    int8 cache and both, at block 8 and ``--shards 4``, for both families,
    one run after another (16 bodies: the depth cut for time)."""
    rates = {}
    for family in ("gpt", "llama"):
        for name, extra in (("block-8", ["--continuous", "--decode-block",
                                         "8"]),
                            ("shards-4", ["--continuous", "--decode-block",
                                          "8", "--shards", "4"])):
            for variant, flags in (("bf16", []), *INT8_VARIANTS):
                summary, _, peak, _ = run_binary(
                    torch, flash, worker,
                    [*GENERATE_ARGS, "--family", family, *extra, *flags],
                    demo=INT8_RATE_DEMO)
                key = f"{family}-{name}-{variant}"
                rates[key] = {"msgs_per_s": summary["msgs_per_s"],
                              "tokens_per_s": summary["tokens_per_s"],
                              "ttft_mean_s": summary["ttft_mean_s"],
                              "peak_mib": peak / 2 ** 20}
                print(f"warm {key} --demo {INT8_RATE_DEMO}: "
                      f"{summary['msgs_per_s']:.3f} "
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
    ``--demo 16`` in bf16 through the batch worker, blocks 1 and 8 and
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
                  f"batch worker's, of {GATE_BODIES} (counted, not gated): "
                  f"{same}",
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
    requests = staggered_requests()[GATE_STAGGER]
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
                len(got) == len(requests) and not bad and launched == 0
                and prefix_launches == 4 and batcher.prefix_len == PREFIX_LEN,
                f"prefix {family} f32 {layout_name} block 8: {len(got)} of "
                f"{len(requests)} staggered suffixes behind the "
                f"{PREFIX_LEN}-token prefix "
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
    """The plain greedy batch worker's ``--demo 16`` replies, with the
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
    summary = binary.run_demo(GATE_BODIES, params, config, service_config,
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
    ``--demo 16`` in bf16 through the batch worker (one prefill of the
    target and one of the draft a batch: ``n_layers + draft_layers``
    forward launches, no lse) and ``--continuous`` (one target prefill an
    insert seeds both caches: ``n_layers`` launches an insert); replies
    counted against the plain greedy batch worker's on the same weights;
    the accepted fraction, rounds a request and second rounds dispatched
    ahead (and still running when the first was read); (b) sampled, the
    GPT at ``--temperature 0.8`` in both workers: 16 of 16 answered, every
    token in the vocabulary; (c) the rejection rule on the card:
    ``_accept_and_fixup`` over 10^5 rows of synthetic draft and target
    distributions (V = 32), the emitted marginal within total variation
    0.01 of the warped target; (d) in f32 the staggered prompts through
    the batch ``speculative_generate`` and the slot engine against the
    port's greedy generate, up to the first near-tie; (e) the GPT with
    ``--quantize-kv`` and with the 37-token prefix, each answering 16 of
    16."""
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
                passes = GATE_BODIES // 8
                per_pass = SERVE_LAYERS + SPEC_DRAFT
            else:
                passes, per_pass = summary["insert_dispatches"], SERVE_LAYERS
            smoke.check(
                logged and (mode == "generate" or passes == GATE_BODIES)
                and launched["flash_fwd"] == per_pass * passes
                and launched["flash_fwd_lse"] == 0,
                f"{label}: logged ({logged}); flash_fwd launches "
                f"{launched['flash_fwd']} = {per_pass} x {passes} prompt "
                f"passes, lse {launched['flash_fwd_lse']}")
            total += launched["flash_fwd"]
            same = count_same(replies_of(summary), base)
            print(f"{label}: replies byte-identical to the plain greedy "
                  f"batch worker's on the same weights, of {GATE_BODIES} "
                  f"(bf16, counted, not gated): {same}", flush=True)
            out["replies_same"][f"{family}-{mode}"] = same
            if mode == "continuous":
                rounds = summary["spec_rounds"]
                stats = {
                    "accepted_fraction": summary["spec_accepted"]
                    / (SPEC_K * rounds),
                    "rounds_per_request": rounds / GATE_BODIES,
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
    and behind the 37-token prefix: 16 of 16 answered, ``n_layers`` forward
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
        smoke.check(summary["insert_dispatches"] == GATE_BODIES
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
    requests = staggered_requests()[GATE_STAGGER]
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
            len(got) == len(requests) and not bad
            and launched == (SERVE_LAYERS + SPEC_DRAFT) * calls,
            f"speculative {family} f32 batch speculative_generate: "
            f"{len(requests)} staggered prompts in {calls} batches "
            f"({launched} flash_fwd "
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
            len(slots) == len(requests) and not slot_bad
            and slot_launches == SERVE_LAYERS * batcher.insert_dispatches,
            f"speculative {family} f32 slot engine: {len(slots)} of "
            f"{len(requests)} staggered prompts in {cycles} cycles, "
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
    the binary's ``--demo 16`` in bf16 through the batch worker (one
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
                passes = (GATE_BODIES // 8 if mode == "generate"
                          else summary["insert_dispatches"])
                logged = any(f"Beam search: {BEAMS} beams" in s for s in logs)
                smoke.check(
                    logged and (mode == "generate" or passes == GATE_BODIES)
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
                  f"the batch worker's, of {GATE_BODIES} (bf16, counted, "
                  f"not gated): "
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
    requests = staggered_requests()[GATE_STAGGER]
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
                len(got) == len(requests) and not bad
                and launched == SERVE_LAYERS * batcher.insert_dispatches,
                f"{variant} {family} f32 slot engine {knobs}: {len(got)} of "
                f"{len(requests)} staggered prompts in {cycles} cycles, "
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
    """The warm ``--demo 16`` rates of plain block-1 ``--continuous``,
    speculative and beams, both families, from the runs above."""
    rates = {**beams["rates"], **spec["rates"]}
    for key in sorted(rates):
        r = rates[key]
        print(f"warm {key} --continuous --demo {GATE_BODIES}: "
              f"{r['msgs_per_s']:.3f} "
              f"msgs/s, {r['tokens_per_s']:.3f} generated tokens/s, mean "
              f"TTFT {r['ttft_mean_s'] * 1e3:.3f} ms", flush=True)
    return rates


# -- host syncs on the per-step paths, and the GELU repair's gain ------------


def old_gelu(x):
    """The GPT's GELU as it was before the repair: its two rounded
    constants built as device tensors on every call (a host-to-device copy
    that waits for the stream on the card).  Kept here only to time and
    to show that wait beside the repaired ``model._gelu``."""
    import torch

    def const(value):
        return torch.tensor(value, dtype=x.dtype, device=x.device)

    cube = x * x * x
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


class gelu_as:
    """Serve with ``gelu`` in place of ``model._gelu`` inside the block."""

    def __init__(self, gelu) -> None:
        self.gelu = gelu

    def __enter__(self):
        from kube_sqs_autoscaler_tpu_torch.workloads import model

        self.saved, model._gelu = model._gelu, self.gelu

    def __exit__(self, *exc) -> None:
        from kube_sqs_autoscaler_tpu_torch.workloads import model

        model._gelu = self.saved


def synced(torch, fn) -> str | None:
    """Run ``fn`` with ``torch.cuda.set_sync_debug_mode("error")``: the
    message of the first call that waited for the card, or None."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            fn()
    except RuntimeError as err:
        return str(err).splitlines()[0][:160]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return None


def tenant_model(torch, family: str, dtype=None):
    """The built-in model of ``family`` with a context for a pooled
    prefix of 512 ahead of a 512-token prompt and 32 generated tokens
    (1056 positions), weights from seed 0, on the card; ``dtype``
    overrides bf16."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        BUILTIN_CONFIGS,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    config = BUILTIN_CONFIGS[family](512, 32, TENANT_PREFIX)
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    params = family_of(config).init_params(
        config, torch.Generator().manual_seed(0), "cuda")
    return config, params


def sync_phase(torch, smoke: Smoke) -> dict:
    """The per-step dispatch paths wait for the card nowhere: for the GPT
    and the llama (the control), one ``decode_step``, one ``block_decode``
    of 8 and one pooled insert of pool hits, each under
    ``torch.cuda.set_sync_debug_mode("error")`` (the engine's counted
    settle is outside).  A second pass runs the same calls with a
    ``LifecycleRegistry`` and a WHEN-only ``CollectiveScheduler`` attached
    to the batcher (the pooled insert's requests traced), plus the comms
    flush of the dispatch-ahead window.  Printed, not gated: the same GPT
    calls through the GELU as it was before the repair."""
    from kube_sqs_autoscaler_tpu_torch.comms import CollectiveScheduler
    from kube_sqs_autoscaler_tpu_torch.obs.lifecycle import (
        LifecycleRegistry,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.decode import block_decode
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    out = {}
    rng = np.random.default_rng(3)
    for family in ("gpt", "llama"):
        config, params = tenant_model(torch, family)
        model = family_of(config)
        layout = model.full
        ids = torch.from_numpy(rng.integers(0, 8192, (8, 512))).cuda()
        with torch.inference_mode():
            _, cache = layout.prefill(params, ids, config,
                                      model.attention_fn_for(config, 512,
                                                             "cuda"))
            current = ids[:, -1].clone()
            done = torch.zeros(8, dtype=torch.bool, device="cuda")
            remaining = torch.full((8,), 32, dtype=torch.long, device="cuda")
        batcher = ContinuousBatcher(
            params, config, 8, 512, 32, decode_block=8, device="cuda",
            tenancy=TenancyConfig(tenants=TENANTS, prefix_pool=8,
                                  prefix_len=TENANT_PREFIX))
        prefixes = tenant_prefixes()
        batcher.submit_many_prefixed([  # installs, outside the gate
            (t, prefixes[t], ids[i, :100].cpu().numpy(), i)
            for i, t in enumerate(TENANTS)])
        while batcher.active:
            batcher.step()
        hits = [(TENANTS[i % 3], prefixes[TENANTS[i % 3]],
                 ids[i, : 64 * (i + 1)].cpu().numpy(), 10 + i)
                for i in range(8)]

        calls = {
            "decode_step": lambda: layout.decode_step(
                params, cache, current, config),
            "block_decode 8": lambda: block_decode(
                params, cache, current, done, remaining, [None] * 8,
                config, layout.decode_step),
            "pooled insert": lambda: batcher.submit_many_prefixed(hits),
        }
        found = {}
        for name, fn in calls.items():
            found[name] = synced(torch, fn)
            smoke.check(found[name] is None,
                        f"sync {family} {name}: no call waited for the card "
                        f"under set_sync_debug_mode('error') ({found[name]})")
        installs = batcher.prefix_pool.installs
        smoke.check(installs == 3 and batcher.prefix_pool.hits == 8,
                    f"sync {family}: the gated insert took 8 pool hits "
                    f"({batcher.prefix_pool.hits}) after {installs} installs")
        while batcher.active:
            batcher.step()
        # the second pass: traced, with the collective scheduler attached
        registry, comms = LifecycleRegistry(), CollectiveScheduler()
        batcher.lifecycle = registry
        batcher.attach_comms(comms)
        traced_hits = [(t, p, i, {"MessageId": f"sync-{family}-{n}"})
                       for n, (t, p, i, _) in enumerate(hits)]
        traced_calls = {
            **{name: fn for name, fn in calls.items()
               if name != "pooled insert"},
            "pooled insert": lambda: batcher.submit_many_prefixed(
                traced_hits),
            "comms flush": lambda: batcher._comms_flush(
                batcher._pending_firsts, batcher._pending_block,
                overlapped=True),
        }
        for name, fn in traced_calls.items():
            found[f"traced {name}"] = synced(torch, fn)
            smoke.check(found[f"traced {name}"] is None,
                        f"sync {family} {name}, traced and comms attached: "
                        f"no call waited for the card "
                        f"({found[f'traced {name}']})")
        while batcher.active:
            batcher.step()
        cc = comms.counters()
        smoke.check(registry.replies == 0 and registry.created == 8
                    and cc["by_kind"]["settle_pull"] >= 1
                    and cc["pending"] == 0
                    and cc["finished_ops"] == cc["dispatched_ops"],
                    f"sync {family}: 8 traced requests, their first-token "
                    f"pulls flushed and finished ({cc['by_kind']}, "
                    f"{cc['finished_ops']} of {cc['dispatched_ops']} ops "
                    f"finished)")
        batcher.attach_comms(None)
        batcher.lifecycle = None
        if family == "gpt":
            with gelu_as(old_gelu):
                before = {name: synced(torch, fn)
                          for name, fn in calls.items()
                          if name != "pooled insert"}
            print(f"sync gpt with the GELU as before the repair "
                  f"(printed, not gated): {before}", flush=True)
            found["before_repair"] = before
        out[family] = found
        del batcher, cache
    return out


GELU_TRAIN_STEPS = 4


def gelu_cost_phase(torch) -> dict:
    """The GELU repair's gain, timed in one call in the order before,
    after, after, before: the GPT decode step (8 rows at a cache of 544),
    warm ``--demo 64 --continuous --decode-block 8`` msgs/s, and the
    flagship train step over ``GELU_TRAIN_STEPS`` ``--overfit`` steps."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads import model, trainer
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    repaired = model._gelu
    config, params = binary.builtin_model("gpt", 512, 32, "cuda")
    layout = family_of(config).full
    ids = torch.zeros((8, 512), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        _, cache = layout.prefill(params, ids, config)
        start = cache["length"].clone()

    def step():
        cache["length"] = start.clone()
        layout.decode_step(params, cache, ids[:, 0], config)

    runs = []
    argv = demo64([*GENERATE_ARGS, "--continuous", "--decode-block", "8",
                   "--device", "cuda"])
    for label, gelu in (("before", old_gelu), ("after", repaired),
                        ("after", repaired), ("before", old_gelu)):
        with gelu_as(gelu):
            with torch.inference_mode():
                step_ms = time_ms(torch, step)
            summary = binary.main(argv)
            train = trainer.main([*TRAIN_ARGS, "--steps",
                                  str(GELU_TRAIN_STEPS), "--log-every", "1",
                                  "--overfit"])
        run = {"gelu": label, "gpt_decode_step_ms": step_ms,
               "block8_msgs_per_s": summary["msgs_per_s"],
               "train_step_ms": 1e3 / train["steps_per_s"]}
        print(f"gelu {label} the repair: GPT decode step {step_ms:.4f} ms, "
              f"block-8 --demo 64 {summary['msgs_per_s']:.3f} msgs/s, "
              f"flagship train step {run['train_step_ms']:.3f} ms",
              flush=True)
        runs.append(run)
        torch.cuda.empty_cache()
    return {"runs": runs}


# -- multi-tenant admission and the per-tenant prefix pool -------------------

TENANT_PREFIX = 512  # the pool's prefix bucket: --seq-len
TENANTS = ("victim0", "victim1", "flood")
TENANT_QUEUE, TENANT_REPLIES = "tenants://jobs", "tenants://replies"
TENANT_LAYERS = 4
POOL_ENTRIES = 8  # --prefix-pool 8


def flood_schedule(cycles: int = 40, flood_start: int = 4,
                   flood_cycles: int = 8, flood_per_cycle: int = 8,
                   victims: int = 2) -> dict[int, list[str]]:
    """The reference's flood-isolation traffic
    (``kube_sqs_autoscaler_tpu/sim/scenarios.py`` ``flood_scenario``, its
    defaults): tenant ``flood`` sends 8 a cycle over cycles 4-11, and
    ``victim0`` and ``victim1`` one every 4 cycles from cycles 0 and 1.
    Returns cycle -> the tenants sending then, in order."""
    out = {}
    for cycle in range(cycles):
        sends = []
        if flood_start <= cycle < flood_start + flood_cycles:
            sends += ["flood"] * flood_per_cycle
        sends += [f"victim{v}" for v in range(victims)
                  if cycle >= v and (cycle - v) % 4 == 0]
        out[cycle] = sends
    return out


def tenant_prefixes(tenants=TENANTS, vocab: int = 8192) -> dict:
    """Each tenant's own seeded 512-token prefix."""
    return {t: np.random.default_rng(1000 + i).integers(0, vocab,
                                                        TENANT_PREFIX)
            for i, t in enumerate(tenants)}


def tenant_bodies(schedule: dict, prefixes: dict, seed: int = 7,
                  vocab: int = 8192) -> dict[int, list[tuple]]:
    """cycle -> ``(tenant, prefix, suffix)`` requests: every suffix 512
    seeded tokens."""
    rng = np.random.default_rng(seed)
    return {cycle: [(t, prefixes[t], rng.integers(0, vocab, 512))
                    for t in tenants]
            for cycle, tenants in schedule.items()}


def tenant_worker(torch, params, config, queue, results, now_fn, tenancy,
                  seq_len: int = 512, shards: int = 1, device="cuda"):
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    service_config = ServiceConfig(
        queue_url=TENANT_QUEUE, batch_size=8, seq_len=seq_len,
        generate_tokens=32, decode_block=8, result_queue_url=TENANT_REPLIES,
        shards=shards)
    return ContinuousWorker(queue, params, config, service_config,
                            result_queue=results, now_fn=now_fn,
                            tenancy=tenancy, device=device)


def tenant_episode(torch, flash, params, config, bodies, tenancy,
                   dt: float = 1.0, shards: int = 1, plan=None,
                   device="cuda") -> dict:
    """Drive ``bodies`` (cycle -> requests, sent before that engine cycle)
    through a tenancy worker on a ``FakeClock`` advancing ``dt`` a cycle,
    until every message is answered; the launch counts are zeroed just
    before and read just after.  Per-tenant TTFT runs on the same clock,
    so with ``dt = 1`` it is in engine cycles.  ``shards > 1`` serves on
    the sharded plane and records each pooled admission's ``(tenant,
    shard, the tenant's home then)``; ``plan`` (a ``FleetFaultPlan``) is
    applied to the worker before each cycle."""
    from kube_sqs_autoscaler_tpu_torch.core import FakeClock
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        collect_replies,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        prefix_pool_key,
    )

    clock = FakeClock(1e6)
    queue = FakeMessageQueue(visibility_timeout=3600.0, now_fn=clock.now)
    results = FakeMessageQueue()
    worker = tenant_worker(torch, params, config, queue, results, clock.now,
                           tenancy, shards=shards, device=device)
    batcher = worker.batcher
    admissions = []
    if shards > 1:
        submit = batcher.submit_many_prefixed

        def recorded(requests):
            rows = submit(requests)
            admissions.extend(
                (tenant, batcher._pool_shard_of(row),
                 batcher._tenant_home.get(prefix_pool_key(tenant, prefix)))
                for row, (tenant, prefix, _, _) in zip(rows, requests))
            return rows

        batcher.submit_many_prefixed = recorded
    sent, tenant_of = [], {}
    per_cycle = {"insert": 0, "decode": 0}
    total = sum(len(v) for v in bodies.values())
    zero_counts(flash)
    start = time.perf_counter()
    cycle = 0
    while cycle < 600:
        for tenant, prefix, suffix in bodies.get(cycle, ()):
            mid = queue.send_message(TENANT_QUEUE, json.dumps(
                {"tenant": tenant, "prefix": prefix.tolist(),
                 "ids": suffix.tolist()}))
            sent.append(mid)
            tenant_of[mid] = tenant
        inserts, decodes = batcher.insert_dispatches, batcher.decode_dispatches
        if plan is not None:
            plan.apply(cycle, worker)
        worker.run_once()
        per_cycle["insert"] = max(per_cycle["insert"],
                                  batcher.insert_dispatches - inserts)
        per_cycle["decode"] = max(per_cycle["decode"],
                                  batcher.decode_dispatches - decodes)
        clock.advance(dt)
        cycle += 1
        answered = worker.processed + worker.shed \
            - worker.shed_by_reason["degraded"]
        if cycle > max(bodies) and answered >= total \
                and batcher.active == 0 and worker.staged == 0:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launched = counts(flash)
    replies, duplicates = collect_replies(results, TENANT_REPLIES)
    ttft = {t: batcher.tenant_ttft_sum.get(t, 0.0)
            / max(1, batcher.tenant_ttft_count.get(t, 0))
            for t in sorted(set(tenant_of.values()))}
    victims = [t for t in ttft if t.startswith("victim")]
    return {
        "sent": sent, "tenant_of": tenant_of, "replies": replies,
        "duplicates": duplicates, "cycles": cycle, "wall_s": wall_s,
        "launches": launched, "per_cycle": per_cycle,
        "queue": queue.get_queue_attributes(TENANT_QUEUE, ()),
        "completed_by_tenant": dict(worker.completed_by_tenant),
        "shed_by_reason": dict(worker.shed_by_reason),
        "pool": batcher.prefix_pool.stats(), "ttft_cycles": ttft,
        "victim_wait_cycles": (
            sum(batcher.tenant_ttft_sum.get(v, 0.0) for v in victims)
            / max(1, sum(batcher.tenant_ttft_count.get(v, 0)
                         for v in victims))),
        "ladder": (worker.ladder.export_state() if worker.ladder else None),
        "inserts": batcher.insert_dispatches,
        "tokens": batcher.tokens_emitted,
        "ttft_mean_s": batcher.ttft_sum / max(1, batcher.ttft_count),
        "admissions": admissions,
        "homes": {key[0]: shard
                  for key, shard in batcher._tenant_home.items()},
        "fair": worker._fair,
    }


def sent_by_tenant(run: dict) -> dict:
    out = {}
    for tenant in run["tenant_of"].values():
        out[tenant] = out.get(tenant, 0) + 1
    return out


def check_tenant_episode(smoke, label, run) -> None:
    """Exactly once, every reply labeled, completions per tenant, pool
    accounting, launches and dispatches a cycle of one episode."""
    replies, sent = run["replies"], run["sent"]
    attrs = run["queue"]
    smoke.check(len(replies) == len(sent) and run["duplicates"] == 0
                and attrs["ApproximateNumberOfMessages"] == "0"
                and attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
                and all(replies[m].get("tenant") == run["tenant_of"][m]
                        for m in sent if m in replies),
                f"{label}: {len(replies)} of {len(sent)} answered once and "
                f"deleted, each reply labeled with its tenant "
                f"({run['duplicates']} duplicates, queue {attrs})")
    pool = run["pool"]
    installs = pool["installs"]
    launched = run["launches"]
    smoke.check(pool["hits"] + pool["misses"] == len(sent)
                and launched["flash_fwd"] == TENANT_LAYERS * installs
                and launched["flash_fwd_lse"] == 0,
                f"{label}: pool hits {pool['hits']} + misses "
                f"{pool['misses']} = {len(sent)} requests; flash_fwd "
                f"launches {launched['flash_fwd']} = {TENANT_LAYERS} layers "
                f"x {installs} installs (none for a hit or a suffix insert "
                f"over {run['inserts']} inserts), lse "
                f"{launched['flash_fwd_lse']}")
    smoke.check(run["per_cycle"]["insert"] <= 1
                and run["per_cycle"]["decode"] <= 1,
                f"{label}: at most one insert dispatch a refill "
                f"({run['per_cycle']['insert']}) and one decode dispatch a "
                f"cycle ({run['per_cycle']['decode']}) over "
                f"{run['cycles']} cycles")


def tenancy_phase(torch, flash, smoke: Smoke) -> dict:
    """Multi-tenant fair admission and the per-tenant prefix pool at both
    built-in models' full width (``--continuous --decode-block 8
    --batch-size 8 --seq-len 512 --generate-tokens 32 --prefix-pool 8``,
    a context of 1056): (a) the reference's flood-isolation traffic in
    bf16 on a ``FakeClock`` under DRR and under the FIFO toggle: exactly
    once, replies labeled, ``completed_by_tenant`` equal to the bodies
    sent, pool hits + misses = requests, ``n_layers x installs`` forward
    launches (none for a hit or a suffix insert, no lse), at most one
    insert and one decode dispatch a cycle, the victims' mean wait in
    engine cycles lower under DRR; (b) in f32 the staggered suffixes
    behind three tenants' prefixes through the block-8 batcher, both
    families and the GPT's int8 cache, against ``generate`` of prefix and
    suffix joined (the int8 layout against its own prefix generate) up to
    the first near-tie; a quiesced row reused with a fresh row's f32
    result; (c) the overload episode: ``--shed-tiers 3`` with the flood
    over its share, tiers 1-3 entered, no victim shed, every message one
    reply or error reply; (d) warm msgs/s and per-tenant mean TTFT with
    the pool beside the same streams with tenancy off (prefix prepended,
    ``--seq-len 1024``), the bf16 replies counted between them; (e) the
    GPT's DRR drain profiled."""
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    out = {"launches": {}}
    prefixes = tenant_prefixes()
    bodies = tenant_bodies(flood_schedule(), prefixes)
    for family in ("gpt", "llama"):
        config, params = tenant_model(torch, family)
        runs = {}
        for mode, fair in (("drr", True), ("fifo", False)):
            tenancy = TenancyConfig(tenants=TENANTS,
                                    prefix_pool=POOL_ENTRIES,
                                    prefix_len=TENANT_PREFIX, fair=fair)
            if family == "gpt" and mode == "drr":
                run, out["profile"] = tenancy_profile(
                    torch, flash, params, config, bodies, tenancy)
            else:
                run = tenant_episode(torch, flash, params, config, bodies,
                                     tenancy)
            label = f"tenancy {family} bf16 {mode}"
            check_tenant_episode(smoke, label, run)
            smoke.check(run["completed_by_tenant"] == sent_by_tenant(run),
                        f"{label}: completed_by_tenant "
                        f"{run['completed_by_tenant']} equals the bodies "
                        f"sent per tenant")
            print(f"{label}: {run['cycles']} cycles, {run['wall_s']:.3f} s "
                  f"on the host clock; pool {run['pool']}; mean wait to "
                  f"the first token in engine cycles by tenant "
                  f"{ {t: round(v, 3) for t, v in run['ttft_cycles'].items()} }",
                  flush=True)
            runs[mode] = run
            out["launches"][f"serve-tenancy-{family}"] = \
                out["launches"].get(f"serve-tenancy-{family}", 0) \
                + run["launches"]["flash_fwd"]
        drr, fifo = (runs[m]["victim_wait_cycles"] for m in ("drr", "fifo"))
        smoke.check(drr < fifo,
                    f"tenancy {family}: the victims' mean wait {drr:.3f} "
                    f"engine cycles under DRR is below FIFO's {fifo:.3f}")
        out[family] = {m: {k: runs[m][k] for k in (
            "cycles", "wall_s", "pool", "ttft_cycles", "victim_wait_cycles",
            "completed_by_tenant", "launches")} for m in runs}
        if family == "gpt":
            out["overload"] = overload_episode(torch, flash, smoke, params,
                                               config)
            out["launches"]["serve-tenancy-gpt"] += \
                out["overload"]["launches"]["flash_fwd"]
            out["rates"] = tenancy_rates(torch, flash, params, config,
                                         bodies)
            out["launches"]["serve-tenancy-gpt"] += \
                out["rates"]["launches"]["tenancy"]
            # the same streams with tenancy off: prompt passes of 1024
            out["launches"]["serve-tenancy-off-gpt"] = \
                out["rates"]["launches"]["off"]
        del params
        torch.cuda.empty_cache()
    out["f32"] = tenancy_f32_checks(torch, flash, smoke)
    return out


OVERLOAD_COLD = ("cold0", "cold1", "cold2", "cold3", "cold4")


def overload_episode(torch, flash, smoke, params, config) -> dict:
    """Part (c) of :func:`tenancy_phase`: the flood traffic plus five cold
    tenants sending one request each over cycles 0-4 (so the pool holds 8
    entries when tier 2 asks it to keep 4), ``shed_tiers=3``, a decode
    deadline of 0.5 s a token on the 1 s a cycle clock, and staging of 16
    a tenant, so the flood alone can fill the 16-deep staging and drive
    the pressure to tier 3."""
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    prefixes = tenant_prefixes((*TENANTS, *OVERLOAD_COLD))
    schedule = flood_schedule()
    for i, tenant in enumerate(OVERLOAD_COLD):
        schedule[i] = [tenant, *schedule[i]]
    bodies = tenant_bodies(schedule, prefixes, seed=8)
    tenancy = TenancyConfig(
        tenants=(*TENANTS, *OVERLOAD_COLD), prefix_pool=POOL_ENTRIES,
        prefix_len=TENANT_PREFIX, shed_tiers=3, decode_slo_s=0.5,
        staging_per_tenant=16)
    run = tenant_episode(torch, flash, params, config, bodies, tenancy)
    label = "tenancy overload gpt bf16"
    replies, sent = run["replies"], run["sent"]
    victim_errors = [m for m in sent if m in replies
                     and "error" in replies[m]
                     and run["tenant_of"][m] != "flood"]
    flood_errors = [m for m in sent if m in replies
                    and "error" in replies[m]
                    and run["tenant_of"][m] == "flood"]
    entered = run["ladder"]["entered_total"]
    shed = run["shed_by_reason"]
    smoke.check(len(replies) == len(sent) and run["duplicates"] == 0
                and run["queue"]["ApproximateNumberOfMessages"] == "0"
                and run["queue"]["ApproximateNumberOfMessagesNotVisible"]
                == "0",
                f"{label}: every one of {len(sent)} messages got exactly "
                f"one reply or error reply ({len(replies)} replies, "
                f"{run['duplicates']} duplicates, {len(flood_errors)} "
                f"flood error replies)")
    smoke.check(not victim_errors and entered[1] > 0 and entered[2] > 0
                and entered[3] > 0 and shed["degraded"] > 0
                and shed["pressure"] > 0 and run["pool"]["evictions"] > 0,
                f"{label}: tiers entered {entered[1:]} (degrade, evict, "
                f"shed), sheds by reason {shed}, pool evictions "
                f"{run['pool']['evictions']}; victim or cold requests "
                f"shed: {len(victim_errors)}")
    print(f"{label}: {run['cycles']} cycles; mean wait in engine cycles "
          f"{ {t: round(v, 3) for t, v in run['ttft_cycles'].items()} }",
          flush=True)
    return {k: run[k] for k in ("cycles", "shed_by_reason", "pool",
                                "ladder", "launches", "ttft_cycles")}


def tenancy_rates(torch, flash, params, config, bodies) -> dict:
    """Part (d) of :func:`tenancy_phase`: the flood streams on the real
    clock, sent before their engine cycle, through the tenancy worker
    with the pool and then through a worker with tenancy off serving
    each request with its prefix prepended (``--seq-len 1024``), one
    after the other: msgs/s, mean time from queue arrival to the first
    token per tenant, and the bf16 replies counted between the two."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        collect_replies, request_id, sent_epoch,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    out, tokens = {"launches": {}}, {}
    total = sum(len(v) for v in bodies.values())
    for mode in ("tenancy", "off"):
        zero_counts(flash)
        queue, results = FakeMessageQueue(), FakeMessageQueue()
        if mode == "tenancy":
            worker = tenant_worker(torch, params, config, queue, results,
                                   None, TenancyConfig(
                                       tenants=TENANTS,
                                       prefix_pool=POOL_ENTRIES,
                                       prefix_len=TENANT_PREFIX))
        else:
            worker = tenant_worker(torch, params, config, queue, results,
                                   None, None, seq_len=1024)
        batcher = worker.batcher
        tenant_of, waits, order = {}, {}, []

        def note(row, ttft, batcher=batcher, tenant_of=tenant_of,
                 waits=waits):
            message = batcher.slots[row].payload
            waits.setdefault(tenant_of[request_id(message)], []).append(
                time.time() - sent_epoch(message))

        batcher._note_ttft = note
        torch.cuda.synchronize()
        start = time.perf_counter()
        cycle = 0
        while cycle < 600:
            for tenant, prefix, suffix in bodies.get(cycle, ()):
                body = ({"tenant": tenant, "prefix": prefix.tolist(),
                         "ids": suffix.tolist()} if mode == "tenancy"
                        else np.concatenate([prefix, suffix]).tolist())
                mid = queue.send_message(TENANT_QUEUE, json.dumps(body))
                tenant_of[mid] = tenant
                order.append(mid)
            worker.run_once()
            cycle += 1
            if cycle > max(bodies) and worker.processed >= total:
                break
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        out["launches"][mode] = counts(flash)["flash_fwd"]
        replies, _ = collect_replies(results, TENANT_REPLIES)
        tokens[mode] = [replies[m].get("tokens") for m in order]
        mean = {t: 1e3 * sum(v) / len(v) for t, v in sorted(waits.items())}
        out[mode] = {"msgs_per_s": worker.processed / elapsed,
                     "elapsed_s": elapsed, "cycles": cycle,
                     "ttft_ms_by_tenant": mean}
        print(f"warm tenancy {mode} (flood traffic, real clock): "
              f"{worker.processed / elapsed:.3f} msgs/s over {cycle} "
              f"cycles; mean ms from queue arrival to the first token by "
              f"tenant { {t: round(v, 3) for t, v in mean.items()} }",
              flush=True)
        del worker, batcher
    same = sum(a == b for a, b in zip(tokens["tenancy"], tokens["off"]))
    out["bf16_replies_same"] = same
    print(f"tenancy bf16 replies equal to the prefix-prepended plain "
          f"path's, of {total} (counted, not gated): {same}", flush=True)
    return out


def tenancy_profile(torch, flash, params, config, bodies, tenancy):
    """Part (e) of :func:`tenancy_phase`: the GPT's DRR episode under
    ``torch.profiler`` (device activity only; the episode's gates read its
    ``FakeClock``, which the profiler does not move): the busy share, and
    the shares of busy time of the pool's gather and of the install
    prefill, each timed alone with CUDA events at the drain's shapes and
    multiplied by the drain's inserts and installs.  Returns ``(the
    episode's run, the profile)``."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import PrefixPool

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = tenant_episode(torch, flash, params, config, bodies, tenancy)
        torch.cuda.synchronize()
    kernels, _ = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    wall_ms = run["wall_s"] * 1e3
    pool = PrefixPool(params, config, entries=POOL_ENTRIES,
                      prefix_len=TENANT_PREFIX, device="cuda")
    prefix = tenant_prefixes()["victim0"]
    zero_counts(flash)
    install_ms = time_ms(torch, lambda: pool._write_entry(
        pool._prefill_entry(prefix), 0), iters=10)
    idx = torch.arange(8, device="cuda") % POOL_ENTRIES

    def gather():
        with torch.inference_mode():
            return [{name: buf[idx] for name, buf in layer.items()}
                    for layer in pool.layers]

    gather_ms = time_ms(torch, gather)
    gather_share = gather_ms * run["inserts"] / busy_ms
    install_share = install_ms * run["pool"]["installs"] / busy_ms
    print(f"profile tenancy gpt DRR drain (profiler on): wall {wall_ms:.3f} "
          f"ms, kernels busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}"
          f"%); the pool gather of 8 rows {gather_ms:.4f} ms x "
          f"{run['inserts']} inserts = {100 * gather_share:.2f}% of busy; "
          f"an install prefill {install_ms:.4f} ms x "
          f"{run['pool']['installs']} installs = {100 * install_share:.2f}% "
          f"of busy", flush=True)
    for ms, count, key in kernels[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    del pool
    return run, {
        "wall_ms": wall_ms, "busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms, "gather_ms": gather_ms,
        "install_ms": install_ms, "gather_share": gather_share,
        "install_share": install_share,
        "top": [(ms, count, key[:90]) for ms, count, key in kernels[:8]]}


def tenancy_f32_checks(torch, flash, smoke: Smoke) -> dict:
    """Part (b) of :func:`tenancy_phase`."""
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    out = {}
    requests = staggered_requests()
    prefixes = tenant_prefixes()
    owner = [TENANTS[i % 3] for i in range(len(requests))]
    tenancy = TenancyConfig(tenants=TENANTS, prefix_pool=POOL_ENTRIES,
                            prefix_len=TENANT_PREFIX)
    for family, quantized in (("gpt", False), ("llama", False),
                              ("gpt", True)):
        config, params = tenant_model(torch, family, torch.float32)
        model = family_of(config)
        layout = model.layout(quantized)
        want, margins = [], []
        with torch.inference_mode():
            caches = {t: layout.prefill_prefix(
                params, torch.from_numpy(p).cuda(), config,
                model.attention_fn_for(config, TENANT_PREFIX, "cuda"))
                for t, p in prefixes.items()} if quantized else {}
            for ids, tenant in zip(requests, owner):
                suffix = torch.from_numpy(ids).cuda()[None]
                if quantized:  # the port's own int8 prefix path
                    def start(suffix=suffix, tenant=tenant):
                        return layout.prefill_with_prefix(
                            params, caches[tenant], suffix, config)
                else:  # prefix and suffix prefilled as one prompt
                    joined = torch.cat([torch.from_numpy(
                        prefixes[tenant]).cuda()[None], suffix], dim=1)

                    def start(joined=joined):
                        return layout.prefill(
                            params, joined, config, model.attention_fn_for(
                                config, joined.shape[1], "cuda"))
                tokens, margin = rollout(
                    torch, start, lambda cache, token: layout.decode_step(
                        params, cache, token, config))
                want.append(tokens)
                margins.append(margin)
            del caches
        batcher = ContinuousBatcher(params, config, 8, 512, 32,
                                    family=family, quantized_kv=quantized,
                                    decode_block=8, tenancy=tenancy,
                                    device="cuda")
        zero_counts(flash)
        got, _ = pooled_drive(batcher, requests, owner, prefixes)
        launched = counts(flash)["flash_fwd"]
        bad, ties = compare_upto_ties(got, want, margins)
        layout_name = "int8-kv" if quantized else "full"
        installs = batcher.prefix_pool.installs
        oracle = ("the int8 prefix generate" if quantized
                  else "generate of prefix + suffix joined")
        smoke.check(len(got) == len(requests) and not bad and installs == 3
                    and launched == TENANT_LAYERS * installs,
                    f"tenancy {family} f32 {layout_name} block 8: "
                    f"{len(got)} of {len(requests)} staggered suffixes "
                    f"behind 3 tenants' pooled {TENANT_PREFIX}-token "
                    f"prefixes ({launched} flash_fwd launches for "
                    f"{installs} installs, none for "
                    f"{batcher.insert_dispatches} pooled inserts); tokens "
                    f"equal to {oracle} up to the first near-tie (margin < "
                    f"{MARGIN:g}): mismatched {bad}; near-ties {ties}")
        out[f"{family}-{layout_name}"] = {"mismatched": bad,
                                          "near_ties": ties}
        if family == "gpt" and not quantized:
            out["quiesce"] = quiesce_check(torch, smoke, batcher, requests,
                                           owner, prefixes, want, margins)
        del batcher, params
        torch.cuda.empty_cache()
    return out


def pooled_drive(batcher, requests, owner, prefixes, every: int = 3,
                 budgets=None):
    """:func:`staggered_drive` through the pool: submit at most 3 requests
    at a time every ``every`` cycles, each behind its tenant's prefix;
    ``budgets`` (request -> tokens) cuts requests' budgets as overload
    tier 1 does.  Returns ``(tokens by request, rows each request took)``."""
    waiting, got, rows_of, cycle = list(enumerate(requests)), {}, {}, 0
    while (waiting or batcher.active) and cycle < 5000:
        free = len(batcher.free_slots)
        if waiting and free and cycle % every == 0:
            take = waiting[:min(free, 3)]
            waiting = waiting[len(take):]
            rows = batcher.submit_many_prefixed([
                (owner[i], prefixes[owner[i]], ids, i) for i, ids in take])
            for row, (i, _) in zip(rows, take):
                rows_of[i] = row
                if budgets and i in budgets:
                    batcher.slots[row].budget = budgets[i]
                    batcher.slots[row].degraded = True
        for i, tokens in batcher.step():
            got[i] = tokens
        cycle += 1
    return got, rows_of


def quiesce_check(torch, smoke, batcher, requests, owner, prefixes, want,
                  margins) -> dict:
    """Overload tier 1's quiesce at block 8 in f32: the first 8 requests
    cut to 16 tokens finish early and are quiesced, and the requests
    admitted after them into the same rows give a fresh row's result
    (``generate`` of prefix and suffix joined, up to the first near-tie)."""
    cut = {i: 16 for i in range(8)}
    tainted = []
    step = batcher.step

    def watched():
        done = step()
        tainted.extend(batcher._tainted)
        return done

    batcher.step = watched
    got, rows_of = pooled_drive(batcher, requests, owner, prefixes,
                                budgets=cut)
    del batcher.step
    reused = sorted(i for i in got if i not in cut
                    and rows_of[i] in {rows_of[j] for j in cut})
    short = all(len(got[i]) == 16 for i in cut)
    bad, ties = compare_upto_ties(
        {i: got[i] for i in reused}, want, margins)
    smoke.check(bool(tainted) and reused and short and not bad,
                f"tenancy gpt f32 quiesce block 8: 8 requests cut to 16 "
                f"tokens ({short}), their rows quiesced and held out of "
                f"admission ({len(set(tainted))} rows tainted), "
                f"{len(reused)} later requests served in those rows equal "
                f"to a fresh row's generate up to the first near-tie: "
                f"mismatched {bad}; near-ties {ties}")
    return {"reused": reused, "mismatched": bad, "tainted": sorted(set(
        tainted))}


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


# -- the serving planes: tenancy on the plane, admission shards, the decode
# plane's speculative rows, the disaggregated planes --------------------------

PLANE_SHARDS = 4  # --shards 4 of --batch-size 8
PLANE_FLIP_AT = 32  # (c): drafting turned off once 32 of 64 are answered
DISAGG_QUEUE, DISAGG_REPLIES = "disagg://jobs", "disagg://replies"
DISAGG_PREFILL = 2  # prefill replicas: 2 x 8 slots
DISAGG_FUSED = 6  # the fused plane at the same slots: 6 shards x 8
DISAGG_KILL_FROM = 10  # the prefill kill: the first cycle from here with
#                        rows waiting for a decode slot


def disagg_schedule(cycles: int = 36, every: int = 2, wave_start: int = 8,
                    wave_cycles: int = 6, wave_per_cycle: int = 6,
                    tenants: int = 2) -> dict[int, list[str]]:
    """The reference's disaggregation traffic
    (``kube_sqs_autoscaler_tpu/sim/scenarios.py`` ``disagg_scenario``, at
    the defaults of ``bench.py``'s disagg suite): ``steady0`` and
    ``steady1`` send one request every 2 cycles from cycles 0 and 1, and a
    prefill wave of 6 a cycle arrives over cycles 8-13; 36 cycles.
    Returns cycle -> the tenants sending then, in order."""
    out = {}
    for cycle in range(cycles):
        sends = [f"steady{i}" for i in range(tenants)
                 if cycle >= i % every and (cycle - i % every) % every == 0]
        if wave_start <= cycle < wave_start + wave_cycles:
            sends += ["wave"] * wave_per_cycle
        out[cycle] = sends
    return out


def disagg_bodies(schedule: dict, seed: int = 11,
                  vocab: int = 8192) -> dict[int, list[str]]:
    """cycle -> JSON bodies: every prompt 512 seeded tokens."""
    rng = np.random.default_rng(seed)
    return {cycle: [json.dumps(rng.integers(0, vocab, 512).tolist())
                    for _ in tenants]
            for cycle, tenants in schedule.items()}


def plane_model(torch, family: str, dtype=None):
    """The built-in model of ``family`` with the speculative rounds' 2k
    positions of headroom (a context of 512 + 32 + 8), weights from seed
    0, on the card; ``dtype`` overrides bf16."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        BUILTIN_CONFIGS,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    config = BUILTIN_CONFIGS[family](512, 32, 0, 2 * SPEC_K)
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    return config, family_of(config).init_params(
        config, torch.Generator().manual_seed(0), "cuda")


def rate_line(label: str, run: dict, power: str) -> str:
    return (f"{label}: {run['msgs_per_s']:.3f} msgs/s, "
            f"{run['tokens_per_s']:.3f} generated tokens/s, mean TTFT "
            f"{run['ttft_mean_s'] * 1e3:.3f} ms over {run['cycles']} cycles "
            f"({power})")


def episode_rates(run: dict, answered: int) -> dict:
    run["msgs_per_s"] = answered / run["wall_s"]
    run["tokens_per_s"] = run["tokens"] / run["wall_s"]
    return run


def differ_before_ties(got: dict, base: dict, margins_of) -> tuple:
    """Requests whose tokens in ``got`` and ``base`` part before the first
    near-tie of the port's own greedy path (``margins_of(i)``, computed only
    for the requests that differ), and those near-ties."""
    bad, ties = [], {}
    for i, tokens in got.items():
        a, b = np.asarray(tokens), np.asarray(base[i])
        if np.array_equal(a, b):
            continue
        first = (int(np.flatnonzero(a != b)[0]) if a.shape == b.shape
                 else 0)
        low = np.flatnonzero(margins_of(i) < MARGIN)
        ties[i] = int(low[0]) if low.size else len(a)
        if first < ties[i]:
            bad.append(i)
    return bad, ties


def path_margins(torch, params, config, model, prompt):
    """The port's greedy path's top-two margins for one prompt."""
    layout = model.full
    ids = torch.as_tensor(np.asarray(prompt)).cuda()[None]
    with torch.inference_mode():
        return rollout(
            torch, lambda: layout.prefill(
                params, ids, config,
                model.attention_fn_for(config, ids.shape[1], "cuda")),
            lambda cache, token: layout.decode_step(params, cache, token,
                                                    config))[1]


def check_plane_homes(smoke, label: str, run: dict) -> dict:
    """Sticky homes on the plane: every tenant's home is the shard of its
    first admission and never moves; an admission off the home is a
    counted spill; the pool installed once for each (tenant, shard) pair
    first seen and evicted nothing."""
    first, on_home, spills = {}, {}, {}
    for tenant, shard, home in run["admissions"]:
        first.setdefault(tenant, home)
        if shard == home:
            on_home[tenant] = on_home.get(tenant, 0) + 1
        else:
            spills[tenant] = spills.get(tenant, 0) + 1
    pairs = {(t, s) for t, s, _ in run["admissions"]}
    pool = run["pool"]
    kept = all(run["homes"].get(t) == h for t, h in first.items())
    smoke.check(
        kept and len(run["admissions"]) == len(run["sent"])
        and pool["installs"] == len(pairs) and pool["evictions"] == 0,
        f"{label}: homes {first} held through the run ({kept}); admissions "
        f"on the home shard by tenant {on_home}, counted spills {spills}; "
        f"pool installs {pool['installs']} = {len(pairs)} (tenant, shard) "
        f"pairs first seen, {pool['evictions']} evictions")
    return {"homes": first, "on_home": on_home, "spills": spills,
            "pairs": len(pairs)}


def plane_tenancy(torch, flash, smoke, power: str, bodies) -> dict:
    """Part (a) of :func:`planes_phase`."""
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    out = {"launches": {}}
    for family in ("gpt", "llama"):
        config, params = tenant_model(torch, family)
        runs = {}
        for mode, fair in (("drr", True), ("fifo", False)):
            tenancy = TenancyConfig(tenants=TENANTS, prefix_pool=POOL_ENTRIES,
                                    prefix_len=TENANT_PREFIX, fair=fair)
            run = tenant_episode(torch, flash, params, config, bodies,
                                 tenancy, shards=PLANE_SHARDS)
            label = f"planes (a) {family} bf16 --shards 4 {mode}"
            check_tenant_episode(smoke, label, run)
            smoke.check(run["completed_by_tenant"] == sent_by_tenant(run),
                        f"{label}: completed_by_tenant "
                        f"{run['completed_by_tenant']} equals the bodies "
                        f"sent per tenant")
            homes = check_plane_homes(smoke, label, run)
            episode_rates(run, len(run["sent"]))
            print(rate_line(f"{label} (FakeClock episode, host wall)", run,
                            power), flush=True)
            print(f"{label}: mean wait to the first token in engine cycles "
                  f"by tenant "
                  f"{ {t: round(v, 3) for t, v in run['ttft_cycles'].items()} }",
                  flush=True)
            runs[mode] = {**{k: run[k] for k in (
                "cycles", "wall_s", "pool", "ttft_cycles",
                "victim_wait_cycles", "completed_by_tenant", "launches",
                "msgs_per_s", "tokens_per_s", "ttft_mean_s")}, **homes}
            out["launches"][f"serve-planes-tenancy-{family}"] = \
                out["launches"].get(f"serve-planes-tenancy-{family}", 0) \
                + run["launches"]["flash_fwd"]
        drr, fifo = (runs[m]["victim_wait_cycles"] for m in ("drr", "fifo"))
        smoke.check(drr < fifo,
                    f"planes (a) {family}: the victims' mean wait {drr:.3f} "
                    f"engine cycles under DRR is below FIFO's {fifo:.3f}")
        out[family] = runs
        del params
        torch.cuda.empty_cache()
    out["f32"] = plane_tenancy_f32(torch, flash, smoke)
    return out


def plane_tenancy_f32(torch, flash, smoke) -> dict:
    """Part (a)'s f32 gate: 12 staggered suffixes behind three tenants'
    pooled prefixes through a 4-shard plane with sticky homes, both
    families, against ``generate`` of prefix and suffix joined up to the
    first near-tie."""
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
    from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
        ShardedBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    out = {}
    requests = staggered_requests()[::2]
    prefixes = tenant_prefixes()
    owner = [TENANTS[i % 3] for i in range(len(requests))]
    tenancy = TenancyConfig(tenants=TENANTS, prefix_pool=POOL_ENTRIES,
                            prefix_len=TENANT_PREFIX)
    for family in ("gpt", "llama"):
        config, params = tenant_model(torch, family, torch.float32)
        model = family_of(config)
        want, margins = [], []
        for ids, tenant in zip(requests, owner):
            joined = np.concatenate([prefixes[tenant], ids])
            layout = model.full
            prompt = torch.from_numpy(joined).cuda()[None]
            with torch.inference_mode():
                tokens, margin = rollout(
                    torch, lambda prompt=prompt: layout.prefill(
                        params, prompt, config, model.attention_fn_for(
                            config, prompt.shape[1], "cuda")),
                    lambda cache, token: layout.decode_step(
                        params, cache, token, config))
            want.append(tokens)
            margins.append(margin)
        plane = ShardedBatcher(params, config, shards=PLANE_SHARDS,
                               shard_slots=8, prompt_len=512,
                               generate_tokens=32, family=family,
                               decode_block=8, tenancy=tenancy,
                               device="cuda")
        zero_counts(flash)
        got, _ = pooled_drive(plane, requests, owner, prefixes)
        launched = counts(flash)["flash_fwd"]
        bad, ties = compare_upto_ties(got, want, margins)
        installs = plane.prefix_pool.installs
        smoke.check(len(got) == len(requests) and not bad
                    and launched == TENANT_LAYERS * installs,
                    f"planes (a) {family} f32 --shards 4: {len(got)} of "
                    f"{len(requests)} suffixes behind 3 tenants' pooled "
                    f"prefixes on sticky homes {dict(plane._tenant_home)} "
                    f"({installs} installs, {launched} flash_fwd launches); "
                    f"tokens equal to generate of prefix + suffix joined up "
                    f"to the first near-tie: mismatched {bad}; near-ties "
                    f"{ties}")
        out[family] = {"mismatched": bad, "near_ties": ties,
                       "installs": installs}
        del plane, params
        torch.cuda.empty_cache()
    return out


def plane_admission(torch, flash, smoke, power: str, bodies) -> dict:
    """Part (b) of :func:`planes_phase`: (a)'s GPT DRR run with
    ``--admission-shards 4``, a ``FleetFaultPlan`` killing the flooding
    tenant's admission shard mid-flood and partitioning another's gossip
    for a window."""
    from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
    from kube_sqs_autoscaler_tpu_torch.workloads.admission_shards import (
        HashRing,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import (
        TenancyConfig,
    )

    ring = HashRing(4)
    flood_shard = ring.shard_of("flood")
    other = (flood_shard + 1) % 4
    plan = FleetFaultPlan(admission_kills=((9, flood_shard),),
                          admission_partitions=((6, 14, other),))
    config, params = tenant_model(torch, "gpt")
    tenancy = TenancyConfig(tenants=TENANTS, prefix_pool=POOL_ENTRIES,
                            prefix_len=TENANT_PREFIX, admission_shards=4)
    run = tenant_episode(torch, flash, params, config, bodies, tenancy,
                         shards=PLANE_SHARDS, plan=plan)
    label = "planes (b) gpt bf16 --shards 4 --admission-shards 4"
    check_tenant_episode(smoke, label, run)
    fair = run.pop("fair")
    killed = fair.shards[flood_shard]
    kills = [e.args for e in fair.events if e.name == "admission-kill"]
    handed = sum(k["handed_back"] for k in kills)
    smoke.check(
        killed.kills == 1 and killed.rehydrations == 1 and handed >= 1
        and killed.rehydrated_records > 0
        and run["completed_by_tenant"] == sent_by_tenant(run),
        f"{label}: admission shard {flood_shard} (the flood's) killed at "
        f"cycle 9 handed {handed} staged request(s) back to the queue, all "
        f"served again (completed_by_tenant {run['completed_by_tenant']}); "
        f"rehydrated from its tombstone with {killed.rehydrated_records} "
        f"records, not cold; shard {other} gossip-partitioned over cycles "
        f"6-13")
    episode_rates(run, len(run["sent"]))
    print(rate_line(f"{label} (FakeClock episode, host wall)", run, power),
          flush=True)
    del params
    torch.cuda.empty_cache()
    return {"launches": {"serve-planes-admission-gpt":
                         run["launches"]["flash_fwd"]},
            "handed_back": handed,
            "rehydrated_records": killed.rehydrated_records,
            "victim_wait_cycles": run["victim_wait_cycles"],
            **{k: run[k] for k in ("cycles", "msgs_per_s", "tokens_per_s",
                                   "ttft_mean_s")}}


def spec_plane_run(torch, flash, params, config, draft: bool,
                   flip_at: int | None = None) -> dict:
    """The ``--demo 64`` bodies through a continuous worker on a 4-shard
    plane at decode block 8 (with ``draft``: the decode plane,
    ``--speculative-draft-layers 2 --speculative-draft-tokens 4``; drafting
    off for new admissions once ``flip_at`` are answered), the launch
    counts zeroed just before and read just after."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        ServiceConfig, collect_replies,
    )

    service = ServiceConfig(queue_url="", batch_size=8, seq_len=512,
                            generate_tokens=32, decode_block=8)
    results = FakeMessageQueue()
    kw = dict(draft_layers=SPEC_DRAFT, draft_tokens=SPEC_K) if draft else {}
    queue, worker = plane_worker(torch, params, config, service,
                                 PLANE_SHARDS, result_queue=results, **kw)
    batcher = worker.batcher
    zero_counts(flash)
    torch.cuda.synchronize()
    start = time.perf_counter()
    cycles = flipped = 0
    while worker.processed < 64 and cycles < 2000:
        worker.run_once()
        cycles += 1
        if flip_at is not None and not flipped \
                and worker.processed >= flip_at:
            batcher.set_speculative(False)
            flipped = cycles
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    replies, duplicates = collect_replies(results, "demo://replies")
    run = {
        "replies": replies, "duplicates": duplicates,
        "launches": counts(flash), "wall_s": wall_s, "cycles": cycles,
        "tokens": batcher.tokens_emitted, "processed": worker.processed,
        "ttft_mean_s": batcher.ttft_sum / max(1, batcher.ttft_count),
        "inserts": batcher.insert_dispatches, "flipped_at_cycle": flipped,
        "draft_inserts": getattr(batcher, "draft_inserts", 0),
        "spec_rounds": batcher.spec_rounds,
        "accept_rate": (batcher.accept_rate() if draft else None),
    }
    return episode_rates(run, worker.processed)


def plane_speculative(torch, flash, smoke, power: str) -> dict:
    """Part (c) of :func:`planes_phase`."""
    out = {"launches": {}}
    for family in ("gpt", "llama"):
        config, params = plane_model(torch, family)
        plain = spec_plane_run(torch, flash, params, config, False)
        spec = spec_plane_run(torch, flash, params, config, True,
                              flip_at=PLANE_FLIP_AT)
        label = f"planes (c) {family} bf16 --shards 4"
        target_inserts = spec["inserts"] - spec["draft_inserts"]
        for name, run in (("plain", plain), ("speculative", spec)):
            want_launches = (SERVE_LAYERS * (run["inserts"]
                                             - run["draft_inserts"])
                             + SPEC_DRAFT * run["draft_inserts"])
            smoke.check(
                len(run["replies"]) == 64 and run["duplicates"] == 0
                and run["launches"]["flash_fwd"] == want_launches
                and run["launches"]["flash_fwd_lse"] == 0,
                f"{label} {name}: 64 of 64 answered once; flash_fwd "
                f"launches {run['launches']['flash_fwd']} = "
                f"{SERVE_LAYERS} x {run['inserts'] - run['draft_inserts']} "
                f"target inserts + {SPEC_DRAFT} x {run['draft_inserts']} "
                f"draft prefills, no lse")
        same = sum(spec["replies"][m]["tokens"] == plain["replies"][m]["tokens"]
                   for m in plain["replies"] if m in spec["replies"])
        smoke.check(spec["spec_rounds"] > 0 and spec["flipped_at_cycle"] > 0,
                    f"{label} speculative: {spec['spec_rounds']} rounds "
                    f"over {target_inserts} inserts, accepted fraction "
                    f"{spec['accept_rate'] or 0.0:.4f}, drafting turned off at "
                    f"cycle {spec['flipped_at_cycle']} (after "
                    f"{PLANE_FLIP_AT} answered); bf16 replies equal to plain "
                    f"--shards 4 (counted, not gated): {same} of 64")
        for name, run in (("plain --shards 4", plain),
                          ("--shards 4 speculative", spec)):
            print(rate_line(f"warm planes {family} {name} --demo 64", run,
                            power), flush=True)
        out[family] = {
            "plain": {k: plain[k] for k in ("msgs_per_s", "tokens_per_s",
                                            "ttft_mean_s", "cycles")},
            "speculative": {k: spec[k] for k in (
                "msgs_per_s", "tokens_per_s", "ttft_mean_s", "cycles",
                "accept_rate", "spec_rounds", "flipped_at_cycle")},
            "bf16_same": same}
        out["launches"][f"serve-planes-spec-{family}"] = \
            plain["launches"]["flash_fwd"] + spec["launches"]["flash_fwd"]
        del params
        torch.cuda.empty_cache()
    out["f32"] = plane_speculative_f32(torch, flash, smoke)
    return out


def plane_speculative_f32(torch, flash, smoke) -> dict:
    """Part (c)'s f32 gate: 12 staggered prompts through a 4-shard plane
    and through the decode plane drafting on it, drafting turned off for
    new admissions once the first 6 are admitted (rows drafted before the
    flip finish drafted, the later ones run plain), both families: equal
    up to the first near-tie of the port's greedy path."""
    from kube_sqs_autoscaler_tpu_torch.planes.engine import (
        DecodePlaneBatcher,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
        ShardedBatcher,
    )

    out = {}
    requests = staggered_requests()[::2]
    for family in ("gpt", "llama"):
        config, params, model = f32_model(torch, family, 2 * SPEC_K)
        kw = dict(shards=PLANE_SHARDS, shard_slots=8, prompt_len=512,
                  generate_tokens=32, family=family, decode_block=8,
                  device="cuda")
        plain, _ = staggered_drive(ShardedBatcher(params, config, **kw),
                                   requests)
        spec_plane = DecodePlaneBatcher(params, config, spec_layers=SPEC_DRAFT,
                                        spec_tokens=SPEC_K, **kw)
        flip = {"after": len(requests) // 2}
        spec, _ = staggered_drive(spec_plane, requests, flip=flip)
        bad, ties = differ_before_ties(
            spec, plain, lambda i: path_margins(torch, params, config,
                                                model, requests[i]))
        drafted = flip.get("drafted_in_flight", 0)
        smoke.check(len(spec) == len(plain) == len(requests) and not bad
                    and spec_plane.spec_rounds > 0 and drafted > 0
                    and spec_plane.spec_flips == 1
                    and not spec_plane.draft_enabled,
                    f"planes (c) {family} f32: {len(spec)} staggered prompts "
                    f"through the decode plane ({spec_plane.spec_rounds} "
                    f"rounds accepting {spec_plane.spec_accepted}), drafting "
                    f"turned off after {flip['after']} admitted with "
                    f"{drafted} drafted rows in flight, equal to plain "
                    f"--shards 4 up to the first near-tie: mismatched {bad}; "
                    f"near-ties {ties}")
        out[family] = {"mismatched": bad, "near_ties": ties,
                       "drafted_in_flight_at_flip": drafted}
        del spec_plane, params
        torch.cuda.empty_cache()
    return out


def disagg_episode(torch, flash, params, config, bodies, *, fused: bool,
                   kill: bool = False, plain_decode: bool = False,
                   device="cuda", lifecycle=None, comms=None,
                   on_cycle=None) -> dict:
    """The disaggregation traffic on a ``FakeClock`` (one cycle a second),
    sent before each fleet cycle, through the fused plane
    (``ShardedWorkerPool.serving`` of 6 shards x 8) or through
    ``DisaggregatedPool.serving(min=1, max=2, decode_shards=4,
    spec_layers=2)`` at 2 prefill replicas x 8 and 4 decode shards x 8,
    until every message is answered.  ``plain_decode``: the decode plane
    steps once a cycle with drafting off (as in the reference's kill
    test).  ``kill``: the first prefill replica found from cycle 10 on
    with rows waiting for a decode slot is killed.  The launch counts are
    zeroed just before and read just after; every ``submit_handoff`` is
    checked to launch no kernel.  Each request's wait from its send to
    its first token on the host is read after every cycle, in cycles.
    ``lifecycle`` (a ``LifecycleRegistry``) and ``comms`` (a
    ``CollectiveScheduler``) attach to the pool before the first cycle;
    ``on_cycle(cycle, pool)`` runs before each cycle, after its sends."""
    from kube_sqs_autoscaler_tpu_torch.core import FakeClock
    from kube_sqs_autoscaler_tpu_torch.fleet import ShardedWorkerPool
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.planes import DisaggregatedPool
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        ServiceConfig, collect_replies,
    )

    clock = FakeClock(1e6)
    queue = FakeMessageQueue(visibility_timeout=3600.0, now_fn=clock.now)
    results = FakeMessageQueue()
    service = ServiceConfig(queue_url=DISAGG_QUEUE, batch_size=8,
                            seq_len=512, generate_tokens=32, decode_block=8,
                            result_queue_url=DISAGG_REPLIES)
    common = dict(result_queue=results, now_fn=clock.now, clock=clock,
                  device=device)
    handoff = {"calls": 0, "launches": 0, "rows": 0}
    if fused:
        pool = ShardedWorkerPool.serving(
            queue, params, config, service, min=DISAGG_FUSED,
            max=DISAGG_FUSED, shards=DISAGG_FUSED, **common)
    else:
        pool = DisaggregatedPool.serving(
            queue, params, config, service, min=1, max=DISAGG_PREFILL,
            initial=DISAGG_PREFILL, decode_shards=PLANE_SHARDS,
            spec_layers=SPEC_DRAFT, spec_tokens=SPEC_K,
            **(dict(draft_enabled=False, decode_steps_per_cycle=1)
               if plain_decode else {}), **common)
        plane = pool.decode.batcher
        submit = plane.submit_handoff

        def counted(donor, records):
            before = flash.kernel_launches
            rows = submit(donor, records)
            handoff["launches"] += flash.kernel_launches - before
            handoff["calls"] += 1
            handoff["rows"] += len(rows)
            return rows

        plane.submit_handoff = counted
    if lifecycle is not None:
        pool.attach_lifecycle(lifecycle)
    if comms is not None:
        pool.attach_comms(comms)
    total = sum(len(v) for v in bodies.values())
    sent, killed, sent_at, first_at = [], None, {}, {}
    zero_counts(flash)
    if device == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    cycle = 0
    while cycle < 600:
        for body in bodies.get(cycle, ()):
            sent.append(queue.send_message(DISAGG_QUEUE, body))
            sent_at[sent[-1]] = cycle
        if kill and killed is None and cycle >= DISAGG_KILL_FROM:
            for replica in pool.members:
                if replica.state == "serving" \
                        and replica.worker.ready_handoffs():
                    killed = (cycle, replica.index,
                              len(replica.worker.ready_handoffs()))
                    pool.kill_worker(replica.index)
                    break
        if on_cycle is not None:
            on_cycle(cycle, pool)
        pool.run_cycle()
        if fused:
            batchers, decode = [pool.worker.batcher], None
        else:
            batchers = [r.worker.batcher for r in pool.members]
            decode = pool.decode.batcher
        for batcher in batchers + ([decode] if decode is not None else []):
            for slot in batcher.slots:
                if slot.busy and slot.produced:
                    first_at.setdefault(slot.payload["MessageId"], cycle)
        clock.advance(1.0)
        cycle += 1
        if cycle > max(bodies) and pool.processed >= total and pool.idle:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launched = counts(flash)
    replies, duplicates = collect_replies(results, DISAGG_REPLIES)
    ttft_sum = sum(b.ttft_sum for b in batchers)
    ttft_count = sum(b.ttft_count for b in batchers)
    run = {
        "sent": sent, "replies": replies, "duplicates": duplicates,
        "cycles": cycle, "wall_s": wall_s, "launches": launched,
        "processed": pool.processed,
        "queue": queue.get_queue_attributes(DISAGG_QUEUE, ()),
        "tokens": (sum(b.tokens_emitted for b in batchers)
                   + (decode.tokens_emitted if decode is not None else 0)),
        "ttft_mean_s": ttft_sum / max(1, ttft_count),
        # send to the first token on the host, in cycles; a request that
        # finished within the cycle of its first token is not seen
        "first_token_cycles": (
            sum(first_at[m] - sent_at[m] for m in first_at)
            / max(1, len(first_at))),
        "first_token_seen": len(first_at),
        "prefill_inserts": (None if fused else
                            sum(b.insert_dispatches for b in batchers)),
        "pool": pool, "killed": killed, "handoff": handoff,
        # host_transfers, decode and insert dispatches over every engine
        "odometers": tuple(
            sum(getattr(b, name) for b in batchers
                + ([decode] if decode is not None else []))
            for name in ("host_transfers", "decode_dispatches",
                         "insert_dispatches")),
    }
    if not fused:
        run.update(kv_handoffs=pool.kv_handoffs_total,
                   kv_bytes=pool.kv_handoffs_total * decode.row_kv_nbytes(),
                   draft_inserts=decode.draft_inserts,
                   accept_rate=decode.accept_rate(),
                   redispatched=pool.redispatched_total,
                   decode_dispatches=decode.decode_dispatches)
    return episode_rates(run, pool.processed)


def check_disagg(smoke, label: str, run: dict) -> None:
    attrs = run["queue"]
    smoke.check(
        len(run["replies"]) == len(run["sent"]) == run["processed"]
        and run["duplicates"] == 0
        and attrs["ApproximateNumberOfMessages"] == "0"
        and attrs["ApproximateNumberOfMessagesNotVisible"] == "0",
        f"{label}: {len(run['replies'])} of {len(run['sent'])} answered "
        f"once and deleted ({run['duplicates']} duplicates, queue {attrs})")
    if run["prefill_inserts"] is None:
        return
    handoff = run["handoff"]
    smoke.check(
        run["launches"]["flash_fwd"] == SERVE_LAYERS * run["prefill_inserts"]
        and handoff["launches"] == 0 and run["draft_inserts"] == 0
        and handoff["rows"] == run["kv_handoffs"] > 0
        and run["launches"]["flash_fwd_lse"] == 0,
        f"{label}: flash_fwd launches {run['launches']['flash_fwd']} = "
        f"{SERVE_LAYERS} layers x {run['prefill_inserts']} prefill "
        f"inserts; {handoff['calls']} handoff batches of "
        f"{handoff['rows']} rows added {handoff['launches']} launches; "
        f"{run['kv_handoffs']} rows, {run['kv_bytes'] / 2**20:.3f} MiB "
        f"copied (target and draft rows); no draft prefill on the decode "
        f"plane ({run['draft_inserts']}), no lse")


def plane_disagg(torch, flash, smoke, power: str) -> dict:
    """Part (d) of :func:`planes_phase`."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.planes.engine import (
        _handoff_rows_impl,
    )

    bodies = disagg_bodies(disagg_schedule())
    total = sum(len(v) for v in bodies.values())
    config, params = plane_model(torch, "gpt")
    t0 = time.perf_counter()
    fused = disagg_episode(torch, flash, params, config, bodies, fused=True)
    check_disagg(smoke, "planes (d) gpt bf16 fused 6 x 8", fused)
    disagg = disagg_episode(torch, flash, params, config, bodies,
                            fused=False)
    check_disagg(smoke, "planes (d) gpt bf16 disaggregated 2 x 8 + 4 x 8",
                 disagg)
    # the same drain again under the profiler, for its busy share
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = disagg_episode(torch, flash, params, config, bodies,
                                  fused=False)
        torch.cuda.synchronize()
    kernels, _ = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    wall_ms = profiled["wall_s"] * 1e3
    print(f"profile planes (d) disaggregated drain (profiler on): wall "
          f"{wall_ms:.3f} ms, kernels busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%) ({power})", flush=True)
    for ms, count, key in kernels[:8]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    del prof, profiled["pool"]
    order = fused["sent"]
    same = sum(disagg["replies"][disagg["sent"][i]]["tokens"]
               == fused["replies"][m]["tokens"] for i, m in enumerate(order))
    print(f"planes (d) gpt bf16: disaggregated replies equal to the fused "
          f"plane's (counted, not gated): {same} of {total}; decode-plane "
          f"accepted fraction {disagg['accept_rate'] or 0.0:.4f}",
          flush=True)
    # one handoff batch of 8 rows, timed alone on the idle planes
    plane = disagg["pool"].decode.batcher
    donor = disagg["pool"].members[0].worker.batcher
    idx = torch.arange(8, device="cuda")
    lasts = torch.zeros(8, dtype=torch.long, device="cuda")
    zero_counts(flash)
    with torch.inference_mode():
        handoff_ms = time_ms(torch, lambda: _handoff_rows_impl(
            plane.cache, plane.draft_cache, plane._current, plane._done,
            plane._remaining, donor.cache, idx, idx, lasts, lasts,
            spec=True, spec_layers=SPEC_DRAFT))
    row_bytes = plane.row_kv_nbytes()
    smoke.check(counts(flash)["flash_fwd"] == 0,
                f"planes (d): one handoff batch of 8 rows ({8 * row_bytes / 2**20:.3f} "
                f"MiB, target and draft rows) takes {handoff_ms:.4f} ms "
                f"({8 * row_bytes / handoff_ms / 1e6:.1f} GB/s copied) and "
                f"launches no kernel ({power})")
    print(f"planes (d): the bf16 runs, the profile and the handoff timing "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    kills = {}
    for name, plain_decode in (("drafted", False), ("plain", True)):
        run = kills[name] = disagg_episode(
            torch, flash, params, config, bodies, fused=False, kill=True,
            plain_decode=plain_decode)
        label = f"planes (d) gpt bf16 disaggregated, {name} decode, " \
                f"prefill kill"
        check_disagg(smoke, label, run)
        smoke.check(run["killed"] is not None and run["redispatched"] > 0,
                    f"{label}: (cycle, replica, rows waiting for a decode "
                    f"slot) {run['killed']}; {run['redispatched']} in-flight "
                    f"request(s) re-dispatched to the surviving prefill "
                    f"replica, every request answered once")
    for label, run in (("fused 6 x 8", fused), ("disaggregated", disagg),
                       ("disaggregated, drafted decode, prefill kill",
                        kills["drafted"]),
                       ("disaggregated, plain decode, prefill kill",
                        kills["plain"])):
        print(rate_line(f"planes (d) gpt bf16 {label} (FakeClock episode, "
                        f"host wall, disagg-wave traffic)", run, power),
              flush=True)
        print(f"planes (d) gpt bf16 {label}: mean wait from the send to the "
              f"first token on the host {run['first_token_cycles']:.3f} "
              f"cycles over {run['first_token_seen']} requests", flush=True)
    launches = sum(r["launches"]["flash_fwd"]
                   for r in (fused, disagg, profiled, *kills.values()))
    del params, fused["pool"], disagg["pool"], plane, donor
    for run in kills.values():
        del run["pool"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32 = plane_disagg_f32(torch, flash, smoke, bodies)
    print(f"planes (d): f32 runs {time.perf_counter() - t0:.3f} s",
          flush=True)
    keep = ("cycles", "wall_s", "msgs_per_s", "tokens_per_s", "ttft_mean_s",
            "first_token_cycles")
    return {
        "launches": {"serve-planes-disagg-gpt": launches + f32["launches"]},
        "fused": {k: fused[k] for k in keep},
        "disagg": {**{k: disagg[k] for k in keep}, "kv_handoffs":
                   disagg["kv_handoffs"], "kv_bytes": disagg["kv_bytes"],
                   "accept_rate": disagg["accept_rate"],
                   "busy_share": busy_ms / wall_ms, "busy_ms": busy_ms},
        "kill": {name: {**{k: run[k] for k in keep}, "killed": run["killed"],
                        "redispatched": run["redispatched"]}
                 for name, run in kills.items()},
        "bf16_same": same, "handoff_ms_8_rows": handoff_ms,
        "row_kv_bytes": row_bytes, "f32": f32["result"],
    }


def plane_disagg_f32(torch, flash, smoke, bodies) -> dict:
    """Part (d)'s f32 gate: the disaggregated planes' replies identical to
    the fused plane's; a difference counts only past the first near-tie
    of the port's greedy path for that prompt."""
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    config, params = plane_model(torch, "gpt", torch.float32)
    model = family_of(config)
    fused = disagg_episode(torch, flash, params, config, bodies, fused=True)
    disagg = disagg_episode(torch, flash, params, config, bodies,
                            fused=False)
    check_disagg(smoke, "planes (d) gpt f32 fused 6 x 8", fused)
    check_disagg(smoke, "planes (d) gpt f32 disaggregated", disagg)
    prompts = [json.loads(b) for c in sorted(bodies) for b in bodies[c]]
    got = {i: disagg["replies"][m]["tokens"]
           for i, m in enumerate(disagg["sent"])}
    base = {i: fused["replies"][m]["tokens"]
            for i, m in enumerate(fused["sent"])}
    bad, ties = differ_before_ties(
        got, base, lambda i: path_margins(torch, params, config, model,
                                          prompts[i]))
    identical = sum(got[i] == base[i] for i in got)
    smoke.check(not bad,
                f"planes (d) gpt f32: disaggregated replies identical to the "
                f"fused plane's for {identical} of {len(got)}; differences "
                f"only past a near-tie of the greedy path: mismatched {bad}; "
                f"near-ties {ties}")
    launches = fused["launches"]["flash_fwd"] + disagg["launches"]["flash_fwd"]
    del params, fused["pool"], disagg["pool"]
    torch.cuda.empty_cache()
    return {"launches": launches, "result": {
        "identical": identical, "mismatched": bad, "near_ties": ties}}


def planes_phase(torch, flash, smoke: Smoke, power: str) -> dict:
    """The serving planes at the built-in models' full width, bf16 with
    random weights from seed 0 (f32 for the parity gates): (a) tenancy on a
    ``--shards 4 --batch-size 8 --decode-block 8 --prefix-pool 8`` plane
    under the tenancy phase's flood traffic, both families, DRR and FIFO
    (exactly once, completions per tenant, the victims' wait lower under
    DRR, homes held, spills counted, one install a (tenant, shard) pair
    first seen; f32 pooled replies against ``generate`` of prefix + suffix
    joined); (b) the GPT's run with ``--admission-shards 4``, the flood's
    admission shard killed mid-flood and another gossip-partitioned
    (exactly once, the staged requests handed back and served again, the
    shard rehydrated, not cold); (c) the decode plane, ``--shards 4
    --speculative-draft-layers 2 --speculative-draft-tokens 4``, both
    families, 64 bodies with drafting turned off mid-drain (launches, the
    accepted fraction, bf16 replies counted against plain ``--shards 4``;
    f32 equal to plain up to ties, drafting also turned off mid-drain);
    (d) ``DisaggregatedPool`` at 2 x 8 prefill and 4 x 8 decode slots
    against the fused 6 x 8 plane on the reference's disaggregation
    traffic, then with a prefill replica killed mid-handoff, on the
    drafted decode plane and on a plain one (exactly once, ``flash_fwd``
    launches = ``n_layers x`` prefill inserts with the handoff adding
    none, f32 replies identical to the fused plane's, bf16 counted; the
    wait from send to first token in cycles, the drain's busy share, one
    handoff batch's time and the bytes copied)."""
    bodies = tenant_bodies(flood_schedule(), tenant_prefixes())
    out = {"launches": {}}
    for part, fn, args in (
            ("tenancy", plane_tenancy, (bodies,)),
            ("admission", plane_admission, (bodies,)),
            ("speculative", plane_speculative, ()),
            ("disagg", plane_disagg, ())):
        start = time.perf_counter()
        out[part] = fn(torch, flash, smoke, power, *args)
        out["launches"].update(out[part].pop("launches"))
        print(f"-- planes {part}: {time.perf_counter() - start:.3f} s",
              flush=True)
    return out


# The orchestration phase: request-lifecycle tracing, the collective
# scheduler (WHEN-only and routed over a modeled torus) and the event
# scheduler with live engine knobs, on the planes and pools above.
ORCH_EVAC_TOTAL = 24  # the evacuation episode's bodies (32 slots)
ORCH_EVAC_POISON = (2, 6, 1)  # shard 1's logits poisoned over cycles [2, 6)
COMMS_MODES = ("off", "disabled", "when", "routed")
ORCH_BLOCK_STEPS = {7: 2, 13: 8}  # fleet cycle -> decode_block staged then
ORCH_SLOT_STEPS = {12: 6, 19: 0}  # fleet cycle -> slot_limit (0: unlimited)
ORCH_PLANE_STEPS = {3: ("plane_ratio", 1), 10: ("plane_ratio", 2),
                    16: ("speculative", False)}


def comms_for(mode: str, shards: int, lifecycle=None):
    """A collective scheduler in one of :data:`COMMS_MODES` (``off``:
    none), routed over ``topology_from_geometry("torus", shards)``."""
    from kube_sqs_autoscaler_tpu_torch.comms import (
        CollectiveScheduler, topology_from_geometry,
    )

    if mode == "off":
        return None
    if mode == "disabled":
        return CollectiveScheduler(enabled=False, lifecycle=lifecycle)
    topology = (topology_from_geometry("torus", shards=shards)
                if mode == "routed" else None)
    return CollectiveScheduler(lifecycle=lifecycle, topology=topology,
                               trace_len=1 << 20)


class timed_waits:
    """Within the block, the host's summed ``perf_counter`` seconds inside
    ``continuous._HostCopy.wait`` (the engines' only wait for a device
    result) and the number of waits."""

    def __enter__(self):
        from kube_sqs_autoscaler_tpu_torch.workloads import continuous

        self.cls = continuous._HostCopy
        original = self.original = self.cls.wait
        self.seconds, self.calls = 0.0, 0
        box = self

        def wait(copy):
            t0 = time.perf_counter()
            try:
                return original(copy)
            finally:
                box.seconds += time.perf_counter() - t0
                box.calls += 1

        self.cls.wait = wait
        return self

    def __exit__(self, *exc) -> None:
        self.cls.wait = self.original


def bytes_by_kind(comms) -> dict:
    out: dict = {}
    for op in (comms.recent if comms is not None else ()):
        out[op.kind] = out.get(op.kind, 0) + op.nbytes
    return out


def evac_episode(torch, flash, params, config, comms,
                 device="cuda") -> dict:
    """The comms suite's evacuation episode: ``ShardedWorkerPool.serving``
    at ``--shards 4 --batch-size 8 --decode-block 8`` (all four shards
    serving, no control loop), 24 ``--demo`` bodies queued (six a shard,
    so the healthy shards have room for the evacuated rows), shard 1's
    logits poisoned over cycles [2, 6) so it is quarantined mid-drain and
    its rows evacuated through a resume insert; a ``FakeClock``, until
    every request is answered.  ``comms`` attaches to the plane.  The
    launch counts are zeroed just before and read just after, and the
    host's waits in ``_HostCopy.wait`` are summed."""
    from kube_sqs_autoscaler_tpu_torch.core import FakeClock
    from kube_sqs_autoscaler_tpu_torch.fleet import (
        FleetDriver, ShardedWorkerPool,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.sim.faults import FleetFaultPlan
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    clock = FakeClock()
    queue = FakeMessageQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    sent = [queue.send_message(CHAOS_QUEUE, body)
            for body in demo_bodies(ORCH_EVAC_TOTAL, config.vocab_size)]
    service = ServiceConfig(
        queue_url=CHAOS_QUEUE, batch_size=8, seq_len=512, generate_tokens=32,
        decode_block=8, result_queue_url=CHAOS_RESULTS, shards=4)
    pool = ShardedWorkerPool.serving(
        queue, params, config, service, result_queue=results, min=4, max=4,
        clock=clock, now_fn=clock.now, probe_after_cycles=CHAOS_PROBE_AFTER,
        device=device)
    if comms is not None:
        pool.worker.batcher.attach_comms(comms)
    driver = FleetDriver(pool, None, cycle_dt=0.05, fault_plan=FleetFaultPlan(
        shard_poisons=(ORCH_EVAC_POISON,)))
    zero_counts(flash)
    if device == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    with timed_waits() as waits:
        stats = driver.run(max_cycles=400, until=lambda: (
            pool.processed >= len(sent) and pool.idle))
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    b = pool.worker.batcher
    return {
        "sent": sent, "replies": drain_raw(results, CHAOS_RESULTS),
        "queue": queue.get_queue_attributes(CHAOS_QUEUE, ()),
        "cycles": stats["cycles"], "wall_s": wall_s,
        "launches": counts(flash)["flash_fwd"],
        "odometers": (b.host_transfers, b.decode_dispatches,
                      b.insert_dispatches),
        "wait_s": waits.seconds, "waits": waits.calls,
        "evacuated": pool.rows_evacuated_total,
        "quarantines": [e.args for e in pool.events
                        if e.name == "shard-quarantine"],
    }


def answered_once(run: dict) -> bool:
    """Every sent request answered exactly once and the queue empty
    (``replies`` either request id -> bodies or request id -> reply)."""
    replies = run["replies"]
    dup = run.get("duplicates", 0) + sum(
        len(v) - 1 for v in replies.values() if isinstance(v, list))
    attrs = run["queue"]
    return (sorted(replies) == sorted(run["sent"]) and dup == 0
            and attrs["ApproximateNumberOfMessages"] == "0"
            and attrs["ApproximateNumberOfMessagesNotVisible"] == "0")


def reply_tokens(run: dict) -> list:
    """The replies' token lists in send order."""
    out = []
    for rid in run["sent"]:
        reply = run["replies"][rid]
        if isinstance(reply, list):
            reply = json.loads(reply[0])
        out.append(reply["tokens"])
    return out


def comms_modes(smoke, label: str, runs: dict, power: str) -> dict:
    """The comms gates over one episode's four modes (see
    :func:`orchestration_phase`); prints bytes by kind, the overlapped
    dispatches, the host's summed wait and each run's wall."""
    from kube_sqs_autoscaler_tpu_torch.comms import (
        assert_no_oversubscription,
    )

    base = runs["off"]
    for mode, run in runs.items():
        smoke.check(answered_once(run),
                    f"orchestration (b) {label} comms {mode}: "
                    f"{len(run['replies'])} of {len(run['sent'])} answered "
                    f"once, queue {run['queue']}")
    same = all(reply_tokens(run) == reply_tokens(base)
               for run in runs.values())
    smoke.check(same, f"orchestration (b) {label}: bf16 replies "
                f"byte-identical across {list(runs)} (comms moves no "
                f"arithmetic)")
    launches = {mode: (run["launches"]["flash_fwd"]
                       if isinstance(run["launches"], dict)
                       else run["launches"]) for mode, run in runs.items()}
    smoke.check(len(set(launches.values())) == 1,
                f"orchestration (b) {label}: flash_fwd launches {launches} "
                f"(comms adds none)")
    odo = {mode: run["odometers"] for mode, run in runs.items()}
    smoke.check(odo["disabled"] == odo["off"],
                f"orchestration (b) {label}: attached-but-disabled "
                f"odometers (host transfers, decode, insert dispatches) "
                f"{odo['disabled']} equal to off {odo['off']}")
    when = runs["when"]["comms"].counters()
    smoke.check(odo["when"][0] < odo["off"][0]
                and odo["when"][1:] == odo["off"][1:]
                and when["overlapped_transfers_total"] >= 1,
                f"orchestration (b) {label}: WHEN-only blocking host "
                f"transfers {odo['when'][0]} < off {odo['off'][0]} at the "
                f"same dispatches, {when['overlapped_transfers_total']} "
                f"overlapped dispatches")
    routed = runs["routed"]["comms"]
    try:
        assert_no_oversubscription(routed.ledger)
        fits = "holds"
    except AssertionError as err:
        fits = f"fails: {err}"
    smoke.check(odo["routed"] == odo["when"] and fits == "holds",
                f"orchestration (b) {label}: routed odometers "
                f"{odo['routed']} equal to WHEN-only's {odo['when']}; "
                f"assert_no_oversubscription {fits} "
                f"({routed.counters()['routing']['routed_ops']} routed ops)")
    for mode in ("when", "routed"):
        cc = runs[mode]["comms"].counters()
        print(f"orchestration (b) {label} comms {mode}: bytes by kind "
              f"{bytes_by_kind(runs[mode]['comms'])}, dispatches by kind "
              f"{cc['by_kind']}, by bucket {cc['by_bucket']}, "
              f"{cc['overlapped_transfers_total']} overlapped of "
              f"{cc['dispatched_ops']} ops", flush=True)
    for mode, run in runs.items():
        print(f"orchestration (b) {label} comms {mode}: host wait in "
              f"_HostCopy.wait {run['wait_s'] * 1e3:.3f} ms over "
              f"{run['waits']} waits, blocking host transfers "
              f"{run['odometers'][0]}, wall {run['wall_s']:.3f} s, "
              f"{run['cycles']} cycles ({power})", flush=True)
    return {mode: {"wait_s": run["wait_s"], "waits": run["waits"],
                   "host_transfers": run["odometers"][0],
                   "wall_s": run["wall_s"], "cycles": run["cycles"],
                   "bytes_by_kind": bytes_by_kind(run.get("comms"))}
            for mode, run in runs.items()}


def orch_lifecycle(torch, flash, smoke, power: str, device="cuda") -> dict:
    """Part (a) of :func:`orchestration_phase`."""
    from kube_sqs_autoscaler_tpu_torch.obs.lifecycle import (
        DURATION_PHASES, LifecycleRegistry, phase_durations, validate_chain,
    )

    bodies = disagg_bodies(disagg_schedule())
    config, params = plane_model(torch, "gpt")
    runs, launches = {}, 0
    for name, kw in (("traced", dict(lifecycle=LifecycleRegistry())),
                     ("kill", dict(lifecycle=LifecycleRegistry(),
                                   kill=True)),
                     ("untraced", {})):
        run = runs[name] = disagg_episode(torch, flash, params, config,
                                          bodies, fused=False, device=device,
                                          **kw)
        run["registry"] = kw.get("lifecycle")
        launches += run["launches"]["flash_fwd"]
        check_disagg(smoke, f"orchestration (a) gpt bf16 {name}", run)
    total = sum(len(v) for v in bodies.values())
    for name in ("traced", "kill"):
        run, reg = runs[name], runs[name]["registry"]
        done = [t for t in reg.done_traces() if "reply" in t.phases]
        problems = {t.rid: validate_chain(t, require_handoff=True)
                    for t in done}
        bad = {rid: p for rid, p in problems.items() if p}
        smoke.check(len(done) == total == reg.replies and not bad
                    and sorted(t.rid for t in done) == sorted(run["sent"]),
                    f"orchestration (a) {name}: {len(done)} of {total} "
                    f"answered requests carry a gap-free monotone chain "
                    f"with one reply stamp and a handoff stamp "
                    f"({reg.duplicates} duplicates closed, {reg.open_count} "
                    f"open); problems {dict(list(bad.items())[:3])}")
    kill = runs["kill"]
    smoke.check(kill["killed"] is not None and kill["redispatched"] > 0,
                f"orchestration (a) kill: (cycle, replica, rows waiting for "
                f"a decode slot) {kill['killed']}; {kill['redispatched']} "
                f"request(s) re-dispatched, their chains continued")
    traced, untraced = runs["traced"], runs["untraced"]
    smoke.check(traced["odometers"] == untraced["odometers"]
                and traced["launches"] == untraced["launches"]
                and traced["kv_handoffs"] == untraced["kv_handoffs"],
                f"orchestration (a): odometers (host transfers, decode, "
                f"insert dispatches) {traced['odometers']} and launches "
                f"{traced['launches']['flash_fwd']} traced, "
                f"{untraced['odometers']} and "
                f"{untraced['launches']['flash_fwd']} untraced")
    same = sum(a == b for a, b in zip(reply_tokens(traced),
                                      reply_tokens(untraced)))
    print(f"orchestration (a) gpt bf16: traced replies equal to untraced "
          f"(counted, not gated) {same} of {total}; tokens/s traced over "
          f"untraced {traced['tokens_per_s'] / untraced['tokens_per_s']:.4f} "
          f"(counted, not gated: host rates) ({power})", flush=True)
    reg = traced["registry"]
    durations = [phase_durations(t) for t in reg.done_traces()]
    p50 = {}
    for phase in DURATION_PHASES:
        vals = sorted(d[phase] for d in durations if phase in d)
        if vals:
            p50[phase] = vals[len(vals) // 2]
    totals = sorted(t.total_s() for t in reg.done_traces()
                    if t.total_s() is not None)
    slo = totals[len(totals) // 4]
    report = reg.attribute_slo(slo)
    print(f"orchestration (a) phase p50 on the episode's FakeClock (one "
          f"cycle a second, so these are cycles of host dynamics, not wall "
          f"time): {p50}; attribute_slo at the first quartile of the "
          f"totals, {slo} s: dominant {report['dominant']}, by phase "
          f"{report['by_phase']} of {report['over_slo']} over",
          flush=True)
    for name, run in runs.items():
        print(rate_line(f"orchestration (a) gpt bf16 {name}", run, power),
              flush=True)
    for run in runs.values():
        del run["pool"], run["registry"]
    del params
    f32_config, f32_params = plane_model(torch, "gpt", torch.float32)
    f32 = {}
    for name, kw in (("traced", dict(lifecycle=LifecycleRegistry())),
                     ("untraced", {})):
        f32[name] = disagg_episode(torch, flash, f32_params, f32_config,
                                   bodies, fused=False, plain_decode=True,
                                   device=device, **kw)
        launches += f32[name]["launches"]["flash_fwd"]
        check_disagg(smoke, f"orchestration (a) gpt f32 plain decode {name}",
                     f32[name])
    smoke.check(reply_tokens(f32["traced"]) == reply_tokens(f32["untraced"])
                and f32["traced"]["odometers"] == f32["untraced"]["odometers"],
                f"orchestration (a) gpt f32 (plain decode): replies "
                f"identical traced and untraced, {total} of {total}; "
                f"odometers {f32['traced']['odometers']}")
    for run in f32.values():
        del run["pool"]
    del f32_params
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "p50": p50, "dominant": report["dominant"],
            "slo_s": slo, "rates": {
                name: {k: run[k] for k in ("msgs_per_s", "tokens_per_s",
                                           "wall_s", "cycles")}
                for name, run in runs.items()}}


def orch_comms(torch, flash, smoke, power: str, device="cuda") -> dict:
    """Part (b) of :func:`orchestration_phase`."""
    config, params = plane_model(torch, "gpt")
    launches = 0
    evac = {}
    for mode in COMMS_MODES:
        comms = comms_for(mode, shards=4)
        run = evac[mode] = evac_episode(torch, flash, params, config, comms,
                                        device=device)
        run["comms"] = comms
        launches += run["launches"]
    for mode, run in evac.items():
        smoke.check(run["evacuated"] > 0 and len(run["quarantines"]) == 1,
                    f"orchestration (b) evacuation {mode}: "
                    f"{run['evacuated']} rows evacuated from "
                    f"{run['quarantines']}")
    kinds = evac["when"]["comms"].counters()["by_kind"]
    smoke.check(kinds["evacuation_kv"] == 1 and kinds["settle_pull"] > 0,
                f"orchestration (b) evacuation: the evacuation recorded as "
                f"one evacuation_kv op, settle pulls {kinds['settle_pull']}")
    out = {"evacuation": comms_modes(smoke, "evacuation", evac, power)}
    bodies = disagg_bodies(disagg_schedule())
    handoff = {}
    for mode in COMMS_MODES:
        comms = comms_for(mode, shards=4)
        with timed_waits() as waits:
            run = handoff[mode] = disagg_episode(
                torch, flash, params, config, bodies, fused=False,
                plain_decode=True, device=device, comms=comms)
        run.update(comms=comms, wait_s=waits.seconds, waits=waits.calls)
        launches += run["launches"]["flash_fwd"]
        check_disagg(smoke, f"orchestration (b) handoff {mode}", run)
    kinds = handoff["when"]["comms"].counters()["by_kind"]
    smoke.check(kinds["handoff_kv"] > 0,
                f"orchestration (b) handoff: {kinds['handoff_kv']} KV "
                f"handoff batches recorded as handoff_kv ops")
    out["handoff"] = comms_modes(smoke, "handoff", handoff, power)
    for run in handoff.values():
        del run["pool"]
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def orch_fleet(torch, flash, smoke, power: str, device="cuda") -> dict:
    """Part (c)'s ``FakeClock`` fleet episodes and knob changes."""
    from kube_sqs_autoscaler_tpu_torch.obs import TickJournal
    from kube_sqs_autoscaler_tpu_torch.obs.journal import read_journal_events
    from kube_sqs_autoscaler_tpu_torch.sched import (
        KnobActuator, ScheduledFleetDriver,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    class Ticks:
        def __init__(self):
            self.records = []

        def on_tick(self, record):
            self.records.append(record)

    launches, out = 0, {}
    for family in ("gpt", "llama"):
        config, params = plane_model(torch, family)
        runs = {}
        for name, cls in (("FleetDriver", None),
                          ("ScheduledFleetDriver", ScheduledFleetDriver)):
            ticks = Ticks()
            zero_counts(flash)
            run = runs[name] = fleet_episode(torch, params, config,
                                             device=device, driver_cls=cls,
                                             observer=ticks)
            run["ticks"] = ticks.records
            run["launches"] = counts(flash)["flash_fwd"]
            launches += run["launches"]
        a, b = runs["FleetDriver"], runs["ScheduledFleetDriver"]
        smoke.check(
            answered_once({**b, "queue": b["queue"].get_queue_attributes(
                FLEET_QUEUE, ())})
            and a["stats"] == b["stats"]
            and a["ticks"] == b["ticks"]
            and a["replies"] == b["replies"] and a["launches"] == b["launches"],
            f"orchestration (c) {family} bf16: ScheduledFleetDriver with no "
            f"knobs armed gives FleetDriver's trajectory "
            f"{b['stats']['replica_trajectory']} ({b['stats']['cycles']} "
            f"cycles), its {len(b['ticks'])} tick records and its replies, "
            f"{len(b['replies'])} answered once; launches {b['launches']}")
        out[family] = {"cycles": b["stats"]["cycles"],
                       "trajectory": b["stats"]["replica_trajectory"]}
        for run in runs.values():
            del run["pool"]
        del params
    # the knobs: f32, decode_block 8 -> 2 -> 8 and slot_limit 6 -> 0
    config, params = plane_model(torch, "gpt", torch.float32)
    model = family_of(config)
    work = Path(os.environ.get("TMPDIR", "/tmp")) / f"orch-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    journal_path = work / "knobs.jsonl"
    staged = []

    def knobs(pool, clock):
        journal = TickJournal(str(journal_path), meta={"phase": "orch"})
        return KnobActuator(pool, armed=("decode_block", "slot_limit"),
                            clock=clock, journal=journal)

    def on_cycle(cycle, pool, actuator):
        for steps, knob in ((ORCH_BLOCK_STEPS, "decode_block"),
                            (ORCH_SLOT_STEPS, "slot_limit")):
            if cycle in steps and actuator.set(knob, steps[cycle]):
                staged.append((knob, steps[cycle], actuator.clock.now()))

    zero_counts(flash)
    still = fleet_episode(torch, params, config, device=device,
                          driver_cls=ScheduledFleetDriver)
    swap = fleet_episode(torch, params, config, device=device,
                         driver_cls=ScheduledFleetDriver, knobs=knobs,
                         on_cycle=on_cycle)
    launches += counts(flash)["flash_fwd"]
    actuator = swap["actuator"]
    actuator.journal.close()
    lines = read_journal_events(str(journal_path), "knob")
    applied = [(c["knob"], c["value"], c["t"]) for c in actuator.changes]
    final = [r.worker.batcher.decode_block for r in swap["pool"].members
             if r.state == "serving"]
    smoke.check(
        answered_once({**swap, "queue": swap["queue"].get_queue_attributes(
            FLEET_QUEUE, ())})
        and applied == staged and len(applied) == 4
        and [(e["knob"], e["value"]) for e in lines]
        == [(k, v) for k, v, _ in applied] and set(final) == {8},
        f"orchestration (c) gpt f32 knobs: {len(swap['replies'])} answered "
        f"once; each change applied at the safe point of the cycle that "
        f"staged it {applied} (staged {staged}) and journaled as a knob "
        f"line ({len(lines)}); serving replicas at decode_block {final}")
    prompts = {rid: json.loads(body) for rid, body in zip(
        swap["sent"], demo_bodies(64, config.vocab_size))}
    got = {rid: json.loads(v[0])["tokens"] for rid, v in
           swap["replies"].items()}
    base = {rid: json.loads(v[0])["tokens"] for rid, v in
            still["replies"].items()}
    bad, ties = differ_before_ties(got, base, lambda rid: path_margins(
        torch, params, config, model, prompts[rid]))
    identical = sum(got[r] == base.get(r) for r in got)
    smoke.check(not bad and sorted(got) == sorted(base),
                f"orchestration (c) gpt f32: greedy replies across the "
                f"decode_block swap equal to the no-swap run's for "
                f"{identical} of {len(got)}; differences only past a "
                f"near-tie: mismatched {bad}; near-ties {ties}")
    del still["pool"], swap["pool"], params
    out["knobs"] = {"applied": applied, "identical": identical}
    learned = orch_learned_knobs(torch, flash, smoke, device)
    launches += learned.pop("launches")
    out["learned knobs"] = learned
    # the disaggregated pool: plane_ratio and speculative
    config, params = plane_model(torch, "gpt")
    plane_journal = work / "plane-knobs.jsonl"
    holder, ratio = {}, []

    def plane_cycle(cycle, pool):
        if "actuator" not in holder:
            holder["actuator"] = KnobActuator(
                pool, armed=("plane_ratio", "speculative"),
                journal=TickJournal(str(plane_journal), meta={}))
        actuator = holder["actuator"]
        if cycle in ORCH_PLANE_STEPS:
            actuator.set(*ORCH_PLANE_STEPS[cycle])
        actuator.apply()  # the safe point: between two pool cycles
        ratio.append(pool.replicas)

    bodies = disagg_bodies(disagg_schedule())
    run = disagg_episode(torch, flash, params, config, bodies, fused=False,
                         device=device, on_cycle=plane_cycle)
    launches += run["launches"]["flash_fwd"]
    actuator = holder["actuator"]
    actuator.journal.close()
    lines = read_journal_events(str(plane_journal), "knob")
    decode = run["pool"].decode.batcher
    changes = [(c["knob"], c["value"]) for c in actuator.changes]
    smoke.check(
        answered_once(run) and changes == list(ORCH_PLANE_STEPS.values())
        and [(e["knob"], e["value"]) for e in lines] == changes
        and decode.draft_enabled is False and decode.spec_flips == 1
        and 1 in ratio and ratio[-1] == 2,
        f"orchestration (c) disaggregated pool: {len(run['replies'])} of "
        f"{len(run['sent'])} answered once; knob changes {changes} "
        f"journaled ({len(lines)} lines); prefill replicas by cycle "
        f"{ratio[:24]}...; drafting off at the end "
        f"({decode.draft_enabled}, {decode.spec_flips} flip)")
    del run["pool"], params, decode
    if device == "cuda":
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


ORCH_KNOB_LADDER = (2, 4, 8)


def orch_learned_knobs(torch, flash, smoke, device="cuda") -> dict:
    """The learned knob head on the fleet: the ``fleet`` phase's
    ``FakeClock`` episode (bf16 GPT) under the event scheduler, its loop
    thresholding on a knob-headed ``LearnedPolicy`` on the card (the
    reference's seeded ``init_params(9, knob_head=True)``: the repo's
    ``SERVING_POLICY.json`` is a serving-twin checkpoint without a knob
    head, which ``LearnedPolicy`` refuses, the ``policies`` phase), and a
    ``LearnedKnobPolicy`` walking ``decode_block`` over
    :data:`ORCH_KNOB_LADDER` by the network's deltas: exactly once, each
    delta stepped once at the scheduler's safe point, the ladder walk
    the deltas', every change journaled."""
    from collections import Counter

    from kube_sqs_autoscaler_tpu_torch.forecast import DepthHistory
    from kube_sqs_autoscaler_tpu_torch.learn import (
        LearnedPolicy, PolicyCheckpoint, init_params,
    )
    from kube_sqs_autoscaler_tpu_torch.obs import TickJournal
    from kube_sqs_autoscaler_tpu_torch.obs.journal import read_journal_events
    from kube_sqs_autoscaler_tpu_torch.sched import (
        KnobActuator, LearnedKnobPolicy, ScheduledFleetDriver,
    )

    config, params = plane_model(torch, "gpt")
    checkpoint = PolicyCheckpoint(
        theta=torch.as_tensor(init_params(9, 16, knob_head=True),
                              device=device), hidden=16, knob_head=True)
    brain = LearnedPolicy(checkpoint, policy=fleet_gates(),
                          poll_interval=0.1, max_pods=3,
                          history=DepthHistory(64))
    taken: list = []
    take = brain.take_knob_delta

    def recorded_take():
        delta = take()
        taken.append(delta)
        return delta

    brain.take_knob_delta = recorded_take
    work = Path(os.environ.get("TMPDIR", "/tmp")) / f"orch-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    journal_path = work / "learned-knobs.jsonl"

    def knobs(pool, clock):
        return KnobActuator(pool, armed=("decode_block",), clock=clock,
                            journal=TickJournal(str(journal_path), meta={}))

    zero_counts(flash)
    run = fleet_episode(
        torch, params, config, device=device,
        driver_cls=ScheduledFleetDriver, knobs=knobs, depth_policy=brain,
        knob_policy=lambda actuator: LearnedKnobPolicy(
            actuator, brain, ladder=ORCH_KNOB_LADDER), kill=None, hang=None)
    launched = counts(flash)["flash_fwd"]
    actuator = run["actuator"]
    actuator.journal.close()
    lines = read_journal_events(str(journal_path), "knob")
    block, want = 8, []
    for delta in taken:
        if delta:
            idx = max(i for i, rung in enumerate(ORCH_KNOB_LADDER)
                      if rung <= block)
            idx = max(0, min(len(ORCH_KNOB_LADDER) - 1, idx + delta))
            if ORCH_KNOB_LADDER[idx] != block:
                block = ORCH_KNOB_LADDER[idx]
                want.append(block)
    applied = [c["value"] for c in actuator.changes]
    smoke.check(
        answered_once({**run, "queue": run["queue"].get_queue_attributes(
            FLEET_QUEUE, ())})
        and applied == want
        and [e["value"] for e in lines] == applied
        and any(d is not None for d in taken),
        f"orchestration (c) learned knobs: {len(run['replies'])} answered "
        f"once; the network's deltas over {len(taken)} ticks (count by "
        f"delta {dict(sorted(Counter(taken).items(), key=str))}) walked "
        f"decode_block over {ORCH_KNOB_LADDER}: applied {applied}, "
        f"journaled {len(lines)}; replicas "
        f"{run['stats']['replica_trajectory'][:12]}...")
    del run["pool"], params
    return {"launches": launched, "applied": applied,
            "trajectory": run["stats"]["replica_trajectory"]}


def orch_binary(torch, flash, smoke, power: str) -> dict:
    """Part (c)'s worker binary: ``--fleet-max-replicas 3`` beside the
    same flags with ``--scheduler --knobs decode_block,slot_limit
    --journal-path --metrics-port``, ``/metrics`` scraped mid-run."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    work = Path(os.environ.get("TMPDIR", "/tmp")) / f"orch-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    journal = work / "fleet.jsonl"
    argv = [*demo64(GENERATE_ARGS), "--continuous", "--decode-block", "8",
            "--fleet-max-replicas", "3", "--device", "cuda"]
    port = free_port()
    scraped, stop, tries = [], threading.Event(), []

    def scrape():
        while not stop.is_set():
            try:
                status, body = http_get(f"http://127.0.0.1:{port}/metrics",
                                        timeout=2)
            except OSError as err:
                status, body = type(err).__name__, ""
            tries.append((status, len(body)))
            if "engine_knob{" in body:
                scraped.append(body)
                return
            time.sleep(0.02)

    zero_counts(flash)
    plain = worker(argv)
    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    try:
        sched = worker([*argv, "--scheduler", "--knobs",
                        "decode_block,slot_limit", "--journal-path",
                        str(journal), "--metrics-port", str(port)])
    finally:
        stop.set()
        scraper.join(timeout=5)
    torch.cuda.synchronize()
    launched = counts(flash)["flash_fwd"]
    header = json.loads(journal.read_text().splitlines()[0])
    for name, run in (("plain", plain), ("--scheduler", sched)):
        smoke.check(run["processed"] == 64 and len(run["replies"]) == 64
                    and run["duplicate_replies"] == 0,
                    f"orchestration (c) fleet binary {name}: "
                    f"{run['processed']} of 64 processed, "
                    f"{len(run['replies'])} replies, "
                    f"{run['duplicate_replies']} duplicates")
    knob_lines = [ln for ln in scraped[0].splitlines()
                  if "engine_knob{" in ln] if scraped else []
    smoke.check(bool(knob_lines)
                and header.get("meta", {}).get("sched", {}).get("knobs")
                == ["decode_block", "slot_limit"],
                f"orchestration (c) fleet binary --scheduler: engine_knob "
                f"on a mid-run scrape {knob_lines} ({len(tries)} scrapes, "
                f"the last {tries[-3:]}); journal header sched "
                f"{header.get('meta', {}).get('sched')}; knob changes "
                f"{[(c['knob'], c['value']) for c in sched['knob_changes']]}")
    for name, run in (("plain", plain), ("--scheduler --knobs", sched)):
        print(f"orchestration (c) fleet binary {name} (real clock): "
              f"{run['msgs_per_s']:.3f} msgs/s, {run['tokens_per_s']:.3f} "
              f"generated tokens/s, trajectory {run['replica_trajectory']}, "
              f"{run['elapsed_s']:.3f} s ({power})", flush=True)
    return {"launches": launched,
            "plain_msgs_per_s": plain["msgs_per_s"],
            "sched_msgs_per_s": sched["msgs_per_s"],
            "knob_changes": sched["knob_changes"]}


def orchestration_phase(torch, flash, smoke: Smoke, power: str) -> dict:
    """The serving orchestration at the built-in models' full width, bf16
    with random weights from seed 0 (f32 for the parity gates):

    (a) request-lifecycle tracing on the ``planes`` phase's disaggregated
    wave episode (72 prompts of 512 through ``DisaggregatedPool.serving(
    min=1, max=2, decode_shards=4, spec_layers=2)``): traced, traced with
    the prefill kill, untraced.  Every answered request carries a
    gap-free monotone chain with one reply stamp and a handoff stamp;
    odometers and ``flash_fwd`` launches equal traced and untraced; f32
    replies identical traced and untraced (plain decode).

    (b) the collective scheduler on two episodes of the reference's comms
    suite, the sharded pool's evacuation and the disaggregated handoff
    (plain decode), each in four modes: off, attached but disabled,
    WHEN-only and routed over a modeled 4-shard torus.  Exactly once;
    bf16 replies byte-identical; disabled odometers equal to off;
    WHEN-only strictly fewer blocking host transfers with an overlapped
    dispatch; routed odometers equal to WHEN-only's; no modeled link
    oversubscribed.  The host's summed wait in ``_HostCopy.wait`` is
    printed beside each mode.

    (c) the event scheduler: the ``fleet`` phase's ``FakeClock`` episode,
    both families, under ``ScheduledFleetDriver`` with no knobs gives
    ``FleetDriver``'s trajectory, tick records and replies; in f32 the
    ``decode_block`` knob steps 8 -> 2 -> 8 and ``slot_limit`` 6 -> 0
    mid-drain (each change journaled and applied at its safe point;
    greedy replies equal the no-swap run's up to the first near-tie);
    ``plane_ratio`` and ``speculative`` on the disaggregated pool; the
    fleet episode's loop on a knob-headed ``LearnedPolicy`` whose deltas a
    ``LearnedKnobPolicy`` walks over ``decode_block``'s ladder; then the
    worker binary with ``--scheduler --knobs`` beside it without."""
    out = {"launches": {}}
    for part, fn in (("lifecycle", orch_lifecycle), ("comms", orch_comms),
                     ("knobs", orch_fleet), ("binary", orch_binary)):
        start = time.perf_counter()
        out[part] = fn(torch, flash, smoke, power)
        out["launches"][f"serve-orchestration-{part}"] = \
            out[part].pop("launches")
        print(f"-- orchestration {part}: {time.perf_counter() - start:.3f} s",
              flush=True)
    return out


class StubTokenizer:
    """HF-shaped ``encode`` / ``decode`` over a byte vocabulary (ids are
    the text's UTF-8 bytes): the worker's text path on a machine without
    ``transformers``."""

    vocab_size = 256

    def __len__(self) -> int:
        return self.vocab_size

    def encode(self, text):
        return list(text.encode())[:64]

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids).decode(errors="replace")


def trainer_run(torch, flash, argv: list[str]) -> dict:
    """One in-process run of the trainer binary: its summary, the
    kernels' launches (zeroed just before, read just after) and, on the
    card, the run's peak memory in GiB."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    cuda = "cuda" in argv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_counts(flash)
    summary = trainer.main(argv)
    if cuda:
        torch.cuda.synchronize()
    return {"summary": summary, "launches": counts(flash),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
            if cuda else 0.0}


def step_busy(torch, argv: list[str]) -> dict:
    """One warm step of the trainer's own step function under
    ``torch.profiler``: wall time, the kernels' busy time and share, and
    the attention kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile

    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    args = trainer.build_parser().parse_args(argv)
    run = trainer.setup(args)
    state, step_fn = run["state"], run["step_fn"]
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, args.vocab_size, (args.batch_size,
                                                args.seq_len),
                           generator=g).to(args.device)
    for _ in range(2):
        state, loss = step_fn(state, tokens)
    float(loss)
    if args.device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, loss = step_fn(state, tokens)
        float(loss)
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels, _ = device_breakdown(prof)
    busy_ms = sum(ms for ms, _, _ in kernels)
    attention_ms = sum(ms for ms, _, key in kernels if "flash_" in key)
    del run, state, step_fn
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "attention_share": attention_ms / max(busy_ms, 1e-9),
            "top": [(ms, n, key[:90]) for ms, n, key in kernels[:6]]}


def print_train(label: str, run: dict, power: str,
                busy: dict | None = None) -> dict:
    summary = run["summary"]
    step_ms = 1e3 / summary["steps_per_s"]
    mfu = summary["mfu"]
    line = (f"training {label}: steady step {step_ms:.3f} ms, "
            f"{summary['tokens_per_s']:.1f} tokens/s, MFU "
            f"{'not known' if mfu is None else f'{100 * mfu:.2f}%'}, peak "
            f"memory {run['peak_gib']:.3f} GiB")
    if busy is not None:
        line += (f", busy {busy['busy_ms']:.3f} of {busy['wall_ms']:.3f} ms "
                 f"({100 * busy['busy_share']:.1f}%, profiler on; attention "
                 f"kernels {100 * busy['attention_share']:.1f}% of busy)")
    print(line + f" ({power})", flush=True)
    return {"step_ms": step_ms, "tokens_per_s": summary["tokens_per_s"],
            "mfu": mfu, "peak_gib": run["peak_gib"],
            **({"busy_share": busy["busy_share"],
                "attention_share": busy["attention_share"]} if busy else {})}


def check_learns(smoke: Smoke, label: str, run: dict, steps: int) -> None:
    losses = run["summary"]["losses"]
    smoke.check(len(losses) == steps and all(map(math.isfinite, losses))
                and losses[-1] < losses[0],
                f"{label}: {steps} losses, finite and falling: "
                f"{[round(x, 4) for x in losses]}")


def train_llama(torch, flash, smoke: Smoke, power: str,
                device="cuda") -> dict:
    """(a) The flagship llama cell through the trainer binary, 10
    ``--overfit`` steps full causal, then with ``--sliding-window 512``:
    the loss falls, and the lse forward, dq and dk/dv kernels launch
    ``n_layers`` times a step each (no dense fallback)."""
    out = {"launches": {}}
    for label, extra in (("llama", []),
                         (f"llama-window{LLAMA_TRAIN_WINDOW}",
                          ["--sliding-window", str(LLAMA_TRAIN_WINDOW)])):
        argv = [*LLAMA_TRAIN_ARGS, *extra]
        run = trainer_run(torch, flash, [*argv, "--steps", str(TRAIN_STEPS),
                                         "--log-every", "1", "--overfit"])
        check_learns(smoke, label, run, TRAIN_STEPS)
        per_step = TRAIN_LAYERS * TRAIN_STEPS if device == "cuda" else 0
        want = {"flash_fwd": 0, "flash_fwd_lse": per_step,
                "flash_bwd_dq": per_step, "flash_bwd_dkv": per_step}
        smoke.check(run["launches"] == want,
                    f"{label}: launches {run['launches']}, want {want} "
                    "(n_layers a step each: the GQA-native kernels, the "
                    "window bound in)")
        out[label] = print_train(label, run, power, step_busy(torch, argv))
        out["launches"][f"train-{label}"] = run["launches"]
    return out


def train_checkpoint(torch, flash, smoke: Smoke, power: str,
                     device="cuda") -> dict:
    """(b) The flagship GPT at 4 layers: 6 steps in one run, and 3 steps
    with ``--checkpoint-every 3`` then ``--resume`` for 3 more; the losses
    of the two must be equal.  Then the worker binary serves the
    checkpoint: its greedy replies over the demo bodies must equal serving
    the resumed run's in-memory parameters."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        TrainCheckpointer, load_model_manifest,
    )

    root = Path("build") / "chip_smoke" / "checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    base = [*SHORT_TRAIN_ARGS, "--log-every", "1"]
    whole = trainer_run(torch, flash, [*base, "--steps", "6"])
    first = trainer_run(torch, flash, [*base, "--steps", "3",
                                       "--checkpoint-dir", str(root),
                                       "--checkpoint-every", "3"])
    second = trainer_run(torch, flash, [*base, "--steps", "3",
                                        "--checkpoint-dir", str(root),
                                        "--resume"])
    want = whole["summary"]["losses"]
    got = first["summary"]["losses"] + second["summary"]["losses"]
    same_first = first["summary"]["losses"] == want[:3]
    smoke.check(same_first, f"checkpoint: the first 3 steps repeat the "
                f"uninterrupted run's bit for bit: {got[:3]} vs {want[:3]}")
    smoke.check(got == want and second["summary"]["final_step"] == 6,
                f"checkpoint: 3 + 3 resumed steps' losses equal the "
                f"uninterrupted 6 bit for bit: {got} vs {want}")
    steps = TrainCheckpointer(root)._steps()
    smoke.check(steps == [3, 6], f"checkpoint: steps on disk {steps}")
    family, config = load_model_manifest(root)
    argv = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
            "--generate-tokens", "16", "--result-queue-url",
            "demo://replies", "--device", device]
    served = worker.main([*argv, "--checkpoint-dir", str(root)])
    service_config = worker.ServiceConfig(
        queue_url="", batch_size=8, seq_len=512, generate_tokens=16,
        result_queue_url="demo://replies")
    direct = worker.run_demo(16, second["summary"]["params"], config,
                             service_config, torch.device(device))
    same = replies_of(served) == replies_of(direct)
    smoke.check(same and len(served["replies"]) == 16,
                f"checkpoint: the worker's {len(served['replies'])} replies "
                f"from --checkpoint-dir ({family}) equal serving the "
                "in-memory parameters")
    print(f"training checkpoint: 3 + 3 resumed steps {got}, uninterrupted "
          f"{want}; save + resume on the card ({power})", flush=True)
    return {"launches": {"train-checkpoint": {
        name: first["launches"][name] + second["launches"][name]
        for name in first["launches"]}}, "losses": got}


def train_moe(torch, flash, smoke: Smoke, power: str,
              device="cuda") -> dict:
    """(c) Both families at the flagship widths with ``--moe`` (8
    experts, top-2), 5 ``--overfit`` steps: the loss falls; the worker
    refuses the MoE checkpoint with the reference's error.  Step time
    and peak memory printed (the GShard dense dispatch, as the reference
    computes it)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker

    out = {"launches": {}}
    for label, argv in (("gpt-moe", TRAIN_ARGS),
                        ("llama-moe", LLAMA_TRAIN_ARGS)):
        root = Path("build") / "chip_smoke" / label
        shutil.rmtree(root, ignore_errors=True)
        run = trainer_run(torch, flash, [
            *argv, "--moe", "--moe-experts", "8", "--moe-top-k", "2",
            "--steps", "5", "--log-every", "1", "--overfit",
            "--checkpoint-dir", str(root), "--checkpoint-every", "0"])
        check_learns(smoke, label, run, 5)
        per_step = TRAIN_LAYERS * 5 if device == "cuda" else 0
        smoke.check(run["launches"]["flash_bwd_dq"] == per_step,
                    f"{label}: launches {run['launches']}")
        try:
            worker.main(["--demo", "1", "--checkpoint-dir", str(root),
                         "--device", device])
            refused = "served"
        except ValueError as err:
            refused = str(err)
        smoke.check("routed-expert" in refused,
                    f"{label}: the worker refuses the MoE checkpoint: "
                    f"{refused[:100]}")
        out[label] = print_train(label, run, power)
        out["launches"][f"train-{label}"] = run["launches"]
        shutil.rmtree(root, ignore_errors=True)
    return out


def train_lora(torch, flash, smoke: Smoke, power: str,
               device="cuda") -> dict:
    """(d) ``--lora-rank 8`` on the flagship llama, 5 ``--overfit``
    steps: the untargeted weights of the merged checkpoint equal the
    seeded base bit for bit, the adapters moved, and the worker serving
    the checkpoint replies as serving ``merge_lora`` of the base and the
    saved adapters."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        TrainCheckpointer, load_model_manifest,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.llama import (
        init_llama_params,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.lora import (
        LoraConfig, merge_lora,
    )

    root = Path("build") / "chip_smoke" / "lora"
    shutil.rmtree(root, ignore_errors=True)
    run = trainer_run(torch, flash, [
        *LLAMA_TRAIN_ARGS, "--lora-rank", "8", "--steps", "5",
        "--log-every", "1", "--overfit", "--learning-rate", "1e-3",
        "--checkpoint-dir", str(root)])
    check_learns(smoke, "lora", run, 5)
    family, config = load_model_manifest(root)
    saved = TrainCheckpointer(root).load()
    base = init_llama_params(config, torch.Generator().manual_seed(0),
                             device)
    adapters = {"layers": [
        {name: {k: t.to(device) for k, t in ab.items()}
         for name, ab in layer.items()}
        for layer in saved["lora"]["adapters"]["layers"]]}
    targets = set(LoraConfig().targets)
    frozen_same = all(
        torch.equal(saved["params"]["layers"][i][name].to(device), t)
        for i, layer in enumerate(base["layers"])
        for name, t in layer.items() if name not in targets
    ) and all(torch.equal(saved["params"][name].to(device), base[name])
              for name in ("embed", "final_norm"))
    moved = all(bool(ab["b"].abs().max() > 0)
                for layer in adapters["layers"] for ab in layer.values())
    smoke.check(frozen_same and moved,
                f"lora: untargeted weights equal the seeded base "
                f"({frozen_same}), every adapter's B moved ({moved})")
    merged = merge_lora(base, adapters, LoraConfig(rank=8))
    argv = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
            "--generate-tokens", "16", "--result-queue-url",
            "demo://replies", "--device", device]
    served = worker.main([*argv, "--checkpoint-dir", str(root)])
    direct = worker.run_demo(16, merged, config, worker.ServiceConfig(
        queue_url="", batch_size=8, seq_len=512, generate_tokens=16,
        result_queue_url="demo://replies"), torch.device(device))
    smoke.check(replies_of(served) == replies_of(direct)
                and len(served["replies"]) == 16,
                "lora: the worker's replies from the merged checkpoint "
                "equal serving merge_lora(base, adapters)")
    out = {"lora": print_train("lora", run, power),
           "launches": {"train-lora": run["launches"]}}
    return out


def train_hf(torch, flash, smoke: Smoke, power: str,
             device="cuda") -> dict:
    """(e) ``hf_state_dict_from_llama`` then ``llama_params_from_hf`` on
    the flagship llama's bf16 weights on the card: bit for bit.  The HF
    directory functions and ``--tokenizer`` need ``transformers``; the
    worker's text path runs here with a stub tokenizer, batch and
    continuous, against the same ids sent as id bodies."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads import hf_convert
    from kube_sqs_autoscaler_tpu_torch.workloads.hf_convert import (
        hf_state_dict_from_llama, llama_params_from_hf,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.llama import (
        LlamaConfig, init_llama_params,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.train import param_leaves
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        QueueWorker, ServiceConfig, collect_replies,
    )

    config = LlamaConfig(**LLAMA_TRAIN_DIMS, max_seq_len=2048)
    params = init_llama_params(config, torch.Generator().manual_seed(0),
                               device)
    back = llama_params_from_hf(hf_state_dict_from_llama(params, config),
                                config, device=device)
    same = all(torch.equal(a, b) for a, b in zip(param_leaves(params),
                                                 param_leaves(back)))
    smoke.check(same and len(param_leaves(back)) == len(param_leaves(params)),
                "hf: the flagship llama's bf16 weights round-trip through "
                "the HF state dict bit for bit on the card")
    import importlib.util

    if importlib.util.find_spec("transformers") is None:
        print("hf: transformers is not installed on this machine; the HF "
              "directory functions (load_hf_llama, save_hf_llama, "
              "--hf-checkpoint, --hf-export) and --tokenizer are gated on "
              "the CPU only (tests/test_torch_hf_convert.py)", flush=True)
    else:
        # the directory round trip on the card where transformers is there:
        # the flagship llama's first 2 layers (cut for time) saved as an HF
        # directory, loaded back bit for bit, and served by the worker
        # binary's --hf-checkpoint
        root = Path("build") / "chip_smoke" / "hf"
        shutil.rmtree(root, ignore_errors=True)
        cut = dataclasses.replace(config, n_layers=2)
        cut_params = {**params, "layers": params["layers"][:2]}
        hf_convert.save_hf_llama(cut_params, cut, root)
        read_config, read = hf_convert.load_hf_llama(root, device=device)
        same_dir = read_config == cut and all(
            torch.equal(a, b) for a, b in zip(param_leaves(cut_params),
                                              param_leaves(read)))
        smoke.check(same_dir, "hf: save_hf_llama then load_hf_llama of the "
                    "flagship llama's widths (2 layers) on the card: bit "
                    "for bit")
        from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker

        served = worker.main(["--demo", "8", "--batch-size", "8",
                              "--seq-len", "64", "--generate-tokens", "8",
                              "--hf-checkpoint", str(root), "--device",
                              device])
        smoke.check(served["processed"] == 8, "hf: the worker binary serves "
                    f"the HF directory: {served['processed']} of 8")
        shutil.rmtree(root, ignore_errors=True)
        from importlib.metadata import version

        print(f"hf: transformers {version('transformers')} is installed on "
              "this machine; the HF "
              "directory round trip and --hf-checkpoint ran on the card "
              "(--tokenizer and the logits against transformers' own "
              "forward are gated on the CPU, tests/test_torch_hf_convert.py)",
              flush=True)
    texts = ["hello card", "the quick brown fox", "queue depth 300",
             "scale up", "scale down", "cooldown", "kv cache", "tokens"]
    stub = StubTokenizer()
    small = LlamaConfig(**LLAMA_TRAIN_DIMS, max_seq_len=64)
    ok = True
    for mode in ("batch", "continuous"):
        replies = {}
        for kind in ("text", "ids"):
            queue, results = FakeMessageQueue(), FakeMessageQueue()
            for text in texts:
                body = (json.dumps({"text": text}) if kind == "text"
                        else json.dumps(stub.encode(text)))
                queue.send_message("stub://in", body)
            service = ServiceConfig(queue_url="stub://in", batch_size=8,
                                    seq_len=32, generate_tokens=8,
                                    result_queue_url="stub://out")
            cls = QueueWorker if mode == "batch" else ContinuousWorker
            worker = cls(queue, params, small, service, result_queue=results,
                         device=device,
                         tokenizer=stub if kind == "text" else None)
            if mode == "batch":
                worker.run_once()
            else:
                worker.drain(total=len(texts))
            got, _ = collect_replies(results, "stub://out")
            replies[kind] = got
        text_tokens = sorted(r["tokens"] for r in replies["text"].values())
        id_tokens = sorted(r["tokens"] for r in replies["ids"].values())
        decoded = all(r["text"] == stub.decode(r["tokens"])
                      for r in replies["text"].values())
        ok &= text_tokens == id_tokens and decoded and len(text_tokens) == 8
        smoke.check(text_tokens == id_tokens and decoded,
                    f"tokenizer {mode}: 8 text bodies through a stub "
                    "tokenizer reply with the id bodies' tokens and their "
                    "decoded text")
    return {"roundtrip": same, "tokenizer": ok, "launches": {}}


def train_corpus(torch, flash, smoke: Smoke, power: str,
                 device="cuda") -> dict:
    """(f) ``write_token_shards`` into a directory of the checkout, then
    5 steps of the 4-layer GPT with ``--data-dir``; the native reader
    builds on first use, and its step-0 batch holds windows of the
    corpus."""
    from kube_sqs_autoscaler_tpu_torch.native import tokenreader

    root = Path("build") / "chip_smoke" / "corpus"
    shutil.rmtree(root, ignore_errors=True)
    seq = int(SHORT_TRAIN_ARGS[SHORT_TRAIN_ARGS.index("--seq-len") + 1])
    corpus = np.random.default_rng(3).integers(0, 8192, 1 << 20)
    tokenreader.write_token_shards(root, corpus, 8192, shard_tokens=1 << 18)
    start = time.perf_counter()
    with tokenreader.TokenReader(root, min_window=seq) as reader:
        build_s = time.perf_counter() - start
        batch = reader.batch(8, seq, 0, 0)
    text = corpus.astype(np.int64)
    windows = all(
        any(np.array_equal(text[s:s + seq], row)
            for s in np.flatnonzero(text == row[0]))
        for row in batch)
    smoke.check(windows, f"corpus: the native reader (built and opened in "
                f"{build_s:.3f} s) returns windows of the corpus")
    run = trainer_run(torch, flash, [*SHORT_TRAIN_ARGS, "--steps", "5",
                                     "--log-every", "1", "--data-dir",
                                     str(root)])
    losses = run["summary"]["losses"]
    smoke.check(len(losses) == 5 and all(map(math.isfinite, losses))
                and run["summary"]["final_step"] == 5,
                f"corpus: 5 steps on --data-dir, losses {losses}")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": {"train-corpus": run["launches"]},
            "step_ms": 1e3 / run["summary"]["steps_per_s"]}


def train_observe(torch, flash, smoke: Smoke, power: str,
                  device="cuda") -> dict:
    """(g) ``--profile-dir``: the trace of 2 steps names ``flash_bwd_dq``;
    ``--metrics-port``: a scrape in the middle of a 20-step run has the
    train gauges."""
    root = Path("build") / "chip_smoke" / "train-trace"
    shutil.rmtree(root, ignore_errors=True)
    traced = trainer_run(torch, flash, [*SHORT_TRAIN_ARGS, "--steps", "2",
                                        "--profile-dir", str(root)])
    traces = list(root.glob("*.json"))
    named = any("flash_bwd_dq" in p.read_text() for p in traces)
    smoke.check(named, f"profile: {len(traces)} trace(s), naming "
                f"flash_bwd_dq: {named}")
    port = free_port()
    result = {}
    thread = threading.Thread(target=lambda: result.update(trainer_run(
        torch, flash, [*SHORT_TRAIN_ARGS, "--steps", "20", "--log-every",
                       "1", "--metrics-port", str(port)])))
    thread.start()
    gauges = ("train_tokens_per_sec", "train_mfu", "train_loss",
              "train_step")
    body = ""
    deadline = time.time() + 120
    while time.time() < deadline and thread.is_alive():
        try:
            status, body = http_get(f"http://127.0.0.1:{port}/metrics")
        except OSError:
            status = None
        if status == 200 and all(g in body for g in gauges):
            break
        time.sleep(0.2)
    thread.join()
    scraped = {g: g in body for g in gauges}
    smoke.check(all(scraped.values()) and bool(result),
                f"metrics: a mid-run scrape has the train gauges {scraped}")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": {"train-profiled": traced["launches"],
                         "train-metrics": result.get("launches", {})}}


def training_phase(torch, flash, smoke: Smoke, power: str,
                   device="cuda") -> dict:
    """The rest of training at full width on the card, bf16: (a) the
    flagship llama cell through the trainer binary, full causal and
    windowed; (b) checkpoint, resume and the worker serving the
    checkpoint; (c) MoE, both families; (d) LoRA on the llama; (e) the HF
    state dicts and the worker's text path; (f) the on-disk corpus
    through the native reader; (g) ``--profile-dir`` and
    ``--metrics-port``."""
    out = {"launches": {}}
    for part, fn in (("llama", train_llama), ("checkpoint", train_checkpoint),
                     ("moe", train_moe), ("lora", train_lora),
                     ("hf", train_hf), ("corpus", train_corpus),
                     ("observe", train_observe)):
        start = time.perf_counter()
        out[part] = fn(torch, flash, smoke, power, device)
        out["launches"].update(out[part].pop("launches"))
        print(f"-- training {part}: {time.perf_counter() - start:.3f} s",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# mesh: ring and zig-zag attention, and the trainer over ranks sharing the
# card (torch.distributed.run, gloo with host-staged hops)
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# seconds a launch of ranks may take, build included (the three launches
# run side by side)
MESH_TIMEOUT = 420
MESH_HOP_CASES = [
    # (label, ring | zigzag, (B, H, H_kv, S, D), dtype, window)
    ("ring-bf16", "ring", (4, 16, 16, 8192, 64), "bfloat16", None),
    ("zigzag-bf16", "zigzag", (4, 16, 16, 8192, 64), "bfloat16", None),
    ("ring-f32", "ring", (2, 8, 8, 2048, 64), "float32", None),
    ("zigzag-f32", "zigzag", (2, 8, 8, 2048, 64), "float32", None),
    ("ring-gqa", "ring", (4, 16, 4, 8192, 64), "bfloat16", None),
    ("zigzag-gqa", "zigzag", (4, 16, 4, 8192, 64), "bfloat16", None),
    ("ring-gqa-window512", "ring", (4, 16, 4, 8192, 64), "bfloat16", 512),
]
MESH_TRAIN_STEPS = 3  # cut from 5 for the run's time limit
# the hop cases whose ring call is also run under the sync debug mode
MESH_SYNC_CASES = ("ring-gqa", "zigzag-gqa")
# the flagship GPT stretched over the ring: S = 8192, B = 4, its depth cut
# from 8 layers to 4 for the run's time limit (over gloo a step's gradient
# sum takes most of its time)
MESH_GPT_ARGS = ["--d-model", "1024", "--n-heads", "16", "--n-layers", "4",
                 "--d-ff", "4096", "--vocab-size", "8192", "--seq-len",
                 "8192", "--batch-size", "4", "--device", "cuda"]
# the flagship llama at S = 4096, B = 4, with the window
MESH_LLAMA_ARGS = [*LLAMA_TRAIN_ARGS[:-6], "--seq-len", "4096",
                   "--batch-size", "4", "--device", "cuda",
                   "--sliding-window", "512"]
MESH_TRAIN_RUNS = [
    # (label, args, flags, mesh flags, seq_parallel, model_parallel,
    #  zigzag, steps); all over the MESH_RANKS ranks, data parallel over
    # what the mesh flags leave; the one-process run takes args + flags
    ("gpt-sp4", MESH_GPT_ARGS, [], ["--seq-parallel", "4"], 4, 1, False,
     MESH_TRAIN_STEPS),
    ("gpt-sp4-zigzag", MESH_GPT_ARGS, [], ["--seq-parallel", "4",
                                           "--zigzag"], 4, 1, True,
     MESH_TRAIN_STEPS),
    ("gpt-tp2-sp2", MESH_GPT_ARGS, [], ["--model-parallel", "2",
                                        "--seq-parallel", "2"], 2, 2, False,
     MESH_TRAIN_STEPS),
    ("llama-dp2-sp2-window512", MESH_LLAMA_ARGS, [], ["--seq-parallel",
                                                      "2"], 2, 1, False,
     MESH_TRAIN_STEPS),
    # (c) short runs: the flagship GPT cut to 4 layers, 3 steps
    ("gpt4-moe-dp2-sp2-zigzag", SHORT_TRAIN_ARGS, ["--moe"],
     ["--seq-parallel", "2", "--zigzag"], 2, 1, True, 3),
    ("gpt4-lora8-dp2-sp2", SHORT_TRAIN_ARGS, ["--lora-rank", "8"],
     ["--seq-parallel", "2"], 2, 1, False, 3),
]
# the mesh run's first two losses (at init, then after one update on the
# same --overfit batch) against one process's on the same seed, tokens and
# weights: bf16 activations, whose attention and reductions the ranks sum
# in another order.  The readings on the H100 are the same from run to run
# (PERF.md): dense runs up to 5.3e-5 and 5.1e-4 (the second loss moves
# more: AdamW's first update is about lr * sign(g), so a gradient entry
# near zero that rounds the other way moves by 2 * lr); the limits are ten
# times those.  The MoE run has its own, three to five times its 1.9e-3
# and 1.6e-2: a bf16 router logit that rounds the other way sends a token
# to another expert
MESH_LOSS_TOL = {"dense": (5e-4, 5e-3), "moe": (1e-2, 5e-2)}
MESH_DIR = Path("build") / "chip_smoke" / "mesh"


def ring_hops(size: int, me: int, seq_local: int, window) -> int:
    """Live hops of rank ``me`` of plain ring attention: its own block and
    every earlier rank's block the causal mask (and the window) reaches."""
    hops = 1
    for owner in range(me):
        shift = (me - owner) * seq_local
        if window is None or min(seq_local,
                                 seq_local + window - shift - 1) > 0:
            hops += 1
    return hops


def hop_launches(kind: str, size: int, me: int, seq_local: int, window):
    """Each training kernel's launches of one ring call's forward and
    backward on rank ``me``."""
    return size + 1 if kind == "zigzag" else ring_hops(size, me, seq_local,
                                                       window)


def run_group(cmd: list[str], timeout: float, log: Path) -> int:
    """Run ``cmd`` in a process group of its own with its output in
    ``log``; a run past ``timeout`` is killed with every process it
    started (the ranks too, each in a session of its own: by its
    :data:`LAUNCH_MARK`).  Returns the exit code (``None`` on a
    timeout)."""
    import signal

    log.parent.mkdir(parents=True, exist_ok=True)
    mark = f"{os.getpid()}-{time.time_ns()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **{LAUNCH_MARK: mark})
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                cwd=str(ROOT), env=env,
                                start_new_session=True)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            return None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            left = stop_marked(LAUNCH_MARK, mark)
            if left:
                print(f"chip_smoke: stopped {left} process(es) of the launch "
                      f"left running", flush=True)


def torchrun(nproc: int, args: list[str]) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", *args]


class Launch:
    """One launch of ranks (:func:`run_group`) on a thread of its own, so
    that launches run side by side and this process goes on meanwhile;
    :meth:`wait` starts it if nothing has, and returns ``(rc, wall_s)``."""

    def __init__(self, name: str, cmd: list[str], timeout: float,
                 log: Path) -> None:
        self.name, self.cmd, self.timeout, self.log = name, cmd, timeout, log
        self.thread = None
        self.rc = self.wall = None

    def start(self) -> "Launch":
        if self.thread is None:
            started = time.perf_counter()

            def run() -> None:
                try:
                    self.rc = run_group(self.cmd, self.timeout, self.log)
                finally:
                    self.wall = time.perf_counter() - started

            self.thread = threading.Thread(target=run, daemon=True)
            self.thread.start()
        return self

    def wait(self) -> tuple:
        self.start().thread.join()
        return self.rc, self.wall


class RankLaunches:
    """The three launches of ranks (``mesh``, ``pipe``, ``serve mesh``),
    run side by side: their ranks wait on gloo with the card mostly idle,
    so one launch's wait is another's turn (their step times and rates are
    therefore not those of a launch alone).  Each phase checks its own
    launch's results; the kernels are timed once every launch is done."""

    def __init__(self) -> None:
        self.launches: dict[str, Launch] = {}
        self.one_process: dict = {}
        #: this process's work run while the launches run (the ``sims``
        #: phase: launch-bound host loops, the card mostly idle too)
        self.beside: list = []

    def add(self, name: str, ranks: int, out: Path, flag: str,
            timeout: float, log: Path) -> Launch:
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        self.launches[name] = Launch(name, torchrun(ranks, [
            str(ROOT / "chip_smoke.py"), flag, str(out)]), timeout, log)
        return self.launches[name]

    def start_all(self) -> None:
        for launch in self.launches.values():
            launch.start()

    def wait_all(self) -> None:
        for launch in self.launches.values():
            launch.wait()

    def run_beside(self) -> None:
        while self.beside:
            self.beside.pop(0)()


def card_lock(torch, dist, held: bool):
    """Across concurrent launches, one trainer run at a time that may hold
    a large share of the card (the MoE runs: 9 GiB a rank): rank 0 of the
    launch takes an exclusive lock on a file of the run, the other ranks
    wait at a barrier.  A context manager; a no-op when not ``held``."""
    import contextlib

    @contextlib.contextmanager
    def section():
        if not held:
            yield
            return
        lock = None
        if dist.get_rank() == 0:
            import fcntl

            path = ROOT / "build" / "chip_smoke" / "card.lock"
            path.parent.mkdir(parents=True, exist_ok=True)
            lock = open(path, "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
        dist.barrier()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
            if lock is not None:
                lock.close()

    return section()


def mesh_hops_rank(torch, out: Path, mesh) -> None:
    """The hop checks on one rank: each case's ring or zig-zag attention
    on this rank's shards, its output and q, k, v gradients against one
    process's ``flash.flash_attention`` over the whole sequence (computed
    here on the same inputs), the kernels' launches of the call, and its
    time."""
    import torch.distributed as dist

    from kube_sqs_autoscaler_tpu_torch.workloads import flash, ring, zigzag

    ax = mesh.axis("seq")
    result = {"rank": mesh.rank, "seq_index": ax.index,
              "backend": mesh.transport.backend, "cases": {}}
    for label, kind, (b, h, hkv, s, d), dtype_name, window in \
            MESH_HOP_CASES:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(11)
        q = torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
        dout = torch.randn((b, h, s, d), generator=g, device="cuda").to(
            dtype)
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        want = flash.flash_attention(*full, causal=True, window=window)
        want.backward(dout)
        seq_local = s // ax.size
        perm = (torch.as_tensor(zigzag.zigzag_permutation(s, ax.size))
                if kind == "zigzag" else torch.arange(s))
        idx = perm[ax.index * seq_local:(ax.index + 1) * seq_local].to(
            "cuda")
        attend = (zigzag.make_zigzag_ring_attention(mesh) if kind == "zigzag"
                  else ring.make_ring_attention(mesh, window=window))
        local = [t[:, :, idx].contiguous().requires_grad_()
                 for t in (q, k, v)]
        dout_local = dout[:, :, idx].contiguous()
        dist.barrier()
        zero_counts(flash)
        got = attend(*local)
        got.backward(dout_local)
        torch.cuda.synchronize()
        launches = counts(flash)
        errs = {"out": scaled_err(got, want[:, :, idx])}
        for name, mine, theirs in zip(("dq", "dk", "dv"), local, full):
            errs[name] = scaled_err(mine.grad, theirs.grad[:, :, idx])

        def fwd_bwd():
            x = [t.detach().requires_grad_() for t in local]
            attend(*x).backward(dout_local)

        times = {}
        for what, fn in (("fwd_ms", lambda: attend(*local)),
                         ("fwd_bwd_ms", fwd_bwd)):
            dist.barrier()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            times[what] = (time.perf_counter() - start) / 3 * 1e3
        if label in MESH_SYNC_CASES:
            times["sync"] = transport_only_syncs(torch, mesh, fwd_bwd)
        result["cases"][label] = {"errs": errs, "launches": launches,
                                  **times}
        del full, want, local, got
        torch.cuda.empty_cache()
    (out / f"hops-rank{mesh.rank}.json").write_text(json.dumps(result))


def transport_only_syncs(torch, mesh, fn) -> dict:
    """``fn`` (one ring call's forward and backward, warm) under
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing calls it
    made, beside the transport's own host-staging waits (one stream
    ``synchronize`` before each gloo exchange, which the mode flags)."""
    import warnings

    before = mesh.transport.host_waits
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own one-time notice ("a prototype feature") is no sync
    synced = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    return {"flagged": len(synced),
            "messages": sorted({str(w.message)[:80] for w in synced}),
            "host_waits": mesh.transport.host_waits - before}


def mesh_train_rank(torch, out: Path, label: str, argv: list[str],
                    keep_params: bool = False) -> None:
    """One trainer run on one rank: ``trainer.main`` as the binary runs it,
    then this rank's losses, step rate, kernel launches and peak memory
    (with ``keep_params``, rank 0 also saves the gathered parameters)."""
    import torch.distributed as dist

    from kube_sqs_autoscaler_tpu_torch.workloads import flash, trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts(flash)
    with card_lock(torch, dist, "--moe" in argv):
        summary = trainer.main(argv)
        torch.cuda.synchronize()
    rank = dist.get_rank()
    if rank == 0 and keep_params:
        torch.save(summary["params"], out / f"{label}-params.pt")
    (out / f"{label}-rank{rank}.json").write_text(json.dumps({
        "rank": rank, "losses": summary["losses"],
        "steps_per_s": summary["steps_per_s"],
        "tokens_per_s": summary["tokens_per_s"],
        "launches": counts(flash),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))
    del summary


def mesh_rank_main(argv: list[str]) -> int:
    """``chip_smoke.py --mesh-rank OUT``: the rank side of the ``mesh``
    phase, under ``torch.distributed.run``: the hop checks, then each
    trainer run of :data:`MESH_TRAIN_RUNS`, in one process group."""
    exit_with_owner()
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(argv[0])
    distributed.initialize_from_env(device="cuda")
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=MESH_RANKS,
                                 device="cuda")
    mesh_hops_rank(torch, out, mesh)
    for label, base, flags, meshed, sp, tp, _, steps in MESH_TRAIN_RUNS:
        extra = (["--checkpoint-dir", str(out / label), "--checkpoint-every",
                  "0"] if tp > 1 else [])
        mesh_train_rank(torch, out, label, [
            *base, *flags, "--log-every", "1", "--overfit", *meshed, *extra,
            "--steps", str(steps)], keep_params=tp > 1)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def check_hops(smoke: Smoke, ranks: list[dict], power: str) -> dict:
    """(a) The hops: each case of :data:`MESH_HOP_CASES` on every rank
    against one process's ``flash_attention``, and each rank's exact
    launch counts."""
    result = {"launches": {}, "cases": {}}
    for label, kind, (b, h, hkv, s, d), dtype_name, window in \
            MESH_HOP_CASES:
        tol = TOL[dtype_name]
        total = {}
        per_rank = []
        for r in ranks:
            case = r["cases"][label]
            me = r["seq_index"]
            n = hop_launches(kind, MESH_RANKS, me, s // MESH_RANKS, window)
            want = {"flash_fwd": 0, "flash_fwd_lse": n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
            worst = max(scaled for _, scaled in case["errs"].values())
            smoke.check(
                worst <= tol and case["launches"] == want,
                f"mesh hops {label} rank {r['rank']} (seq {me}): out, dq, "
                f"dk, dv vs one process's flash_attention over S={s}: "
                + ", ".join(f"{n_}={e[1]:.3e}" for n_, e in
                            case["errs"].items())
                + f" (/max(1,|want|), tol {tol:g}); launches "
                f"{case['launches']}, want {want}")
            if "sync" in case:
                sync = case["sync"]
                smoke.check(
                    0 < sync["host_waits"] == sync["flagged"],
                    f"mesh hops {label} rank {r['rank']}: under "
                    f"set_sync_debug_mode('warn') {sync['flagged']} "
                    f"synchronizing calls, the transport's "
                    f"{sync['host_waits']} host stagings (no other wait); "
                    f"{sync['messages']}")
            for name, value in case["launches"].items():
                total[name] = total.get(name, 0) + value
            per_rank.append({"rank": r["rank"], "fwd_ms": case["fwd_ms"],
                             "fwd_bwd_ms": case["fwd_bwd_ms"],
                             "launches": case["launches"],
                             "max_scaled_err": worst})
        print(f"mesh hops {label} {(b, h, hkv, s, d)} {dtype_name} window="
              f"{window}: per-rank fwd ms "
              f"{[round(p['fwd_ms'], 3) for p in per_rank]}, fwd+bwd ms "
              f"{[round(p['fwd_bwd_ms'], 3) for p in per_rank]} "
              f"({MESH_RANKS} ranks sharing one {power}, over "
              f"{ranks[0]['backend']})", flush=True)
        result["cases"][label] = per_rank
        result["launches"][f"mesh-hops-{label}"] = total
    return result


def check_training(torch, smoke: Smoke, out: Path, power: str,
                   one: dict) -> dict:
    """(b) The trainer runs over the ranks: the first two losses against
    one process's first two steps on the same seed, tokens and weights
    (``one``), falling losses, each rank's launches exactly ``n_layers``
    ring calls' worth a step; the tensor-parallel run's checkpoint served
    by the single-card worker."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        load_model_manifest,
    )

    result = {"launches": {}, "runs": {}}
    for label, base, flags, _, sp, tp, zz, steps in MESH_TRAIN_RUNS:
        files = [out / f"{label}-rank{r}.json" for r in range(MESH_RANKS)]
        if not all(f.exists() for f in files):
            smoke.check(False, f"mesh {label}: a rank wrote no result")
            continue
        ranks = [json.loads(f.read_text()) for f in files]
        losses = ranks[0]["losses"]
        single = one[tuple(base + flags)]
        first = single["losses"][0]
        tols = MESH_LOSS_TOL["moe" if "--moe" in flags else "dense"]
        diffs = [abs(a - b) for a, b in zip(losses, single["losses"])]
        smoke.check(
            len(diffs) == 2
            and all(dd <= tol for dd, tol in zip(diffs, tols))
            and all(r["losses"] == losses for r in ranks),
            f"mesh {label}: the first two losses "
            f"{[round(x, 6) for x in losses[:2]]} vs one process's "
            f"{[round(x, 6) for x in single['losses']]} (|d| "
            f"{[f'{dd:.2e}' for dd in diffs]}, tol {list(tols)}: bf16, "
            "summed in another order); every rank reports the same losses")
        smoke.check(len(losses) == steps
                    and all(map(math.isfinite, losses))
                    and losses[-1] < losses[0],
                    f"mesh {label}: {steps} losses, finite and "
                    f"falling: {[round(x, 4) for x in losses]}")
        layers = int(base[base.index("--n-layers") + 1])
        seq = int(base[base.index("--seq-len") + 1])
        window = (int(base[base.index("--sliding-window") + 1])
                  if "--sliding-window" in base else None)
        total = {}
        for r in ranks:
            me = (r["rank"] // tp) % sp
            n = hop_launches("zigzag" if zz else "ring", sp, me, seq // sp,
                             window) * layers * steps
            want = {"flash_fwd": 0, "flash_fwd_lse": n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
            smoke.check(r["launches"] == want,
                        f"mesh {label} rank {r['rank']} (seq {me}): launches "
                        f"{r['launches']}, want {want}")
            for name, value in r["launches"].items():
                total[name] = total.get(name, 0) + value
        result["launches"][f"mesh-train-{label}"] = total
        step_ms = 1e3 / ranks[0]["steps_per_s"]
        peaks = [round(r["peak_gib"], 3) for r in ranks]
        print(f"mesh train {label}: steady step {step_ms:.3f} ms, "
              f"{ranks[0]['tokens_per_s']:.1f} tokens/s, per-rank peak "
              f"memory {peaks} GiB; one process's step "
              f"{single['step_ms']:.3f} ms, peak "
              f"{single['peak_gib']:.3f} GiB "
              f"({MESH_RANKS} ranks sharing one {power}, over gloo)",
              flush=True)
        result["runs"][label] = {"step_ms": step_ms, "peak_gib": peaks,
                                 "losses": losses, "first_one": first,
                                 "one_losses": single["losses"],
                                 "loss_diffs": diffs,
                                 "tokens_per_s": ranks[0]["tokens_per_s"]}
        if tp > 1:
            ckpt = out / label
            family, config = load_model_manifest(ckpt)
            args = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
                    "--generate-tokens", "16", "--result-queue-url",
                    "demo://replies", "--device", "cuda"]
            served = worker.main([*args, "--checkpoint-dir", str(ckpt)])
            params = torch.load(out / f"{label}-params.pt",
                                map_location="cuda", weights_only=True)
            service_config = worker.ServiceConfig(
                queue_url="", batch_size=8, seq_len=512, generate_tokens=16,
                result_queue_url="demo://replies")
            direct = worker.run_demo(16, params, config, service_config,
                                     torch.device("cuda"))
            same = replies_of(served) == replies_of(direct)
            smoke.check(same and len(served["replies"]) == 16,
                        f"mesh {label}: the single-card worker's "
                        f"{len(served['replies'])} replies from the "
                        f"tensor-parallel checkpoint ({family}) equal "
                        "serving the ranks' gathered parameters")
            del params
    return result


def mesh_one_process(torch, flash) -> dict:
    """One process's first two steps of each run's flags without the mesh
    flags, in this process: the losses the mesh run's first two steps must
    equal (the same seed, tokens and weights), its step time and peak
    memory."""
    out = {}
    for _, base, flags, *_ in MESH_TRAIN_RUNS:
        if tuple(base + flags) in out:
            continue
        run = trainer_run(torch, flash, [*base, *flags, "--log-every", "1",
                                         "--overfit", "--steps", "2"])
        summary = run["summary"]
        out[tuple(base + flags)] = {
            "losses": summary["losses"],
            "step_ms": 1e3 / summary["steps_per_s"],
            "peak_gib": run["peak_gib"]}
        del run, summary
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_ranks(torch, flash, smoke: Smoke, power: str,
               launches: RankLaunches) -> dict:
    """(a) and (b): one launch of :data:`MESH_RANKS` ranks runs the hop
    checks and every trainer run; this process checks what they wrote.
    The one-process runs of this phase and of ``pipe`` go first, alone on
    the card; then the ``mesh``, ``pipe`` and ``serve mesh`` launches
    start side by side."""
    one = mesh_one_process(torch, flash)
    launches.one_process["pipe"] = pipe_one_process(torch, flash)
    out = MESH_DIR / "ranks"
    log = MESH_DIR / "ranks.log"
    launches.start_all()
    launches.run_beside()
    rc, wall = launches.launches["mesh"].wait()
    files = [out / f"hops-rank{r}.json" for r in range(MESH_RANKS)]
    ok = rc == 0 and all(f.exists() for f in files)
    smoke.check(ok, f"mesh: {MESH_RANKS} ranks exited "
                f"{'on a timeout' if rc is None else rc} after {wall:.1f} s")
    if not ok:
        print(log.read_text()[-6000:], flush=True)
    result = {"launches": {}, "wall_s": wall, "one_process": {
        " ".join(k): v for k, v in one.items()}}
    if all(f.exists() for f in files):
        hops = check_hops(smoke, [json.loads(f.read_text()) for f in files],
                          power)
        result["launches"].update(hops.pop("launches"))
        result["hops"] = hops
    train = check_training(torch, smoke, out, power, one)
    result["launches"].update(train.pop("launches"))
    result["training"] = train
    return result


def mesh_orbax(torch, smoke: Smoke) -> dict:
    """(d) A directory whose step is shaped as an orbax checkpoint of the
    JAX package (file names only): the worker and the trainer's
    ``--resume`` exit 2 naming the format, without a traceback."""
    import contextlib
    import io

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    root = MESH_DIR / "orbax"
    shutil.rmtree(root, ignore_errors=True)
    step = root / "step_00000002"
    (step / "d").mkdir(parents=True)
    for name in ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt"):
        (step / name).write_text("{}")
    (root / "model_config.json").write_text(json.dumps({
        "family": "gpt", "vocab_size": 256, "d_model": 64, "n_heads": 4,
        "n_layers": 2, "d_ff": 128, "max_seq_len": 64}))
    out = {}
    for label, main, argv in (
            ("worker", worker.main, [
                "--demo", "2", "--seq-len", "16", "--generate-tokens", "2",
                "--checkpoint-dir", str(root), "--device", "cuda"]),
            ("trainer --resume", trainer.main, [
                "--vocab-size", "256", "--d-model", "64", "--n-heads", "4",
                "--n-layers", "2", "--d-ff", "128", "--seq-len", "64",
                "--steps", "1", "--checkpoint-dir", str(root), "--resume",
                "--device", "cuda"])):
        err = io.StringIO()
        code = None
        with contextlib.redirect_stderr(err):
            try:
                main(argv)
            except SystemExit as exit_:
                code = exit_.code
        text = err.getvalue().strip()
        smoke.check(code == 2 and "orbax checkpoint" in text,
                    f"mesh orbax: the {label} exits {code} naming the "
                    f"format: {text.splitlines()[-1] if text else ''}")
        out[label] = code
    return out


def mesh_hop_checks(torch, flash, smoke: Smoke, label, b, h, hkv, sq, sk, d,
                    opts, seed) -> dict:
    """Each training kernel at one hop shape against its plain version on
    the same inputs, in bf16 and in f32, with a random lse cotangent (the
    merge of the hops feeds one back to every hop)."""
    worst_by_name = {}
    for dtype_name in ("bfloat16", "float32"):
        q, k, v, dout = train_inputs(torch, b, h, hkv, sq, sk, d,
                                     getattr(torch, dtype_name), False, seed)
        dout = dout.contiguous()
        out, lse = flash.flash_fwd(q, k, v, need_lse=True, **opts)
        want_out, want_lse = flash.flash_fwd_reference(q, k, v, **opts)
        g = torch.Generator(device="cuda").manual_seed(seed)
        dlse = torch.randn(lse.shape, generator=g, device="cuda")
        args = (q, k, v, dout, want_lse,
                flash.attention_delta(want_out, dout, dlse))
        dq = flash.flash_bwd_dq(*args, **opts)
        dk, dv = flash.flash_bwd_dkv(*args, **opts)
        want_dq = flash.flash_bwd_dq_reference(*args, **opts)
        want_dk, want_dv = flash.flash_bwd_dkv_reference(*args, **opts)
        torch.cuda.synchronize()
        tol = TOL[dtype_name]
        for name, pairs in (
                ("flash_fwd_lse", ((out, want_out), (lse, want_lse))),
                ("flash_bwd_dq", ((dq, want_dq),)),
                ("flash_bwd_dkv", ((dk, want_dk), (dv, want_dv)))):
            errs = [scaled_err(got, want) for got, want in pairs]
            finite = all(bool(torch.isfinite(got).all().item())
                         for got, _ in pairs)
            shaped = all(got.shape == want.shape for got, want in pairs)
            worst = max(scaled for _, scaled in errs)
            smoke.check(
                finite and shaped and worst <= tol,
                f"{name} mesh hop {label} {dtype_name} B={b} H={h} "
                f"H_kv={hkv} S_q={sq} S_k={sk} D={d} causal={opts['causal']} "
                f"window={opts['window']} q_shift={opts['q_shift']} dlse=True:"
                f" max|d|={max(e for e, _ in errs):.3e}, /max(1,|want|)="
                f"{worst:.3e} tol={tol:g} ({TRAIN_TOL_REASON[dtype_name]})")
            worst_by_name.setdefault(name, {})[dtype_name] = worst
        del q, k, v, dout, out, lse, want_out, want_lse, args, dq, dk, dv
        del want_dq, want_dk, want_dv
        torch.cuda.empty_cache()
    return worst_by_name


def mesh_hop_timing(torch, flash, smoke: Smoke) -> dict:
    """The three training kernels at the mesh's hop shapes (B = 4, 16
    heads, D = 64), one process alone on the card: each held against its
    plain version in bf16 and f32 (:func:`mesh_hop_checks`), then timed in
    bf16 beside its plain version, SDPA with the hop's mask and its
    bound."""
    shapes = [
        # (label, H_kv, S_q, S_k, causal, q_shift, window)
        ("ring-diag-2048", 16, 2048, 2048, True, 0, None),
        ("ring-earlier-2048", 16, 2048, 2048, False, 0, None),
        ("zigzag-diag-lo-1024", 16, 1024, 1024, True, 0, None),
        ("zigzag-diag-hi-1024x2048-shift1024", 16, 1024, 2048, True, 1024,
         None),
        ("zigzag-earlier-2048x1024", 16, 2048, 1024, False, 0, None),
        ("zigzag-later-1024x2048", 16, 1024, 2048, False, 0, None),
        ("ring-gqa-window512-earlier-511x2048-shift2048", 4, 511, 2048,
         True, 2048, 512),
    ]
    return hop_timing(torch, flash, smoke, [(label, 4, 16, *rest)
                                           for label, *rest in shapes], 300)


def hop_timing(torch, flash, smoke: Smoke, shapes, seed0: int) -> dict:
    """Each training kernel at ``shapes`` (``(label, B, H, H_kv, S_q, S_k,
    causal, q_shift, window)``, D = 64) against its plain version in bf16
    and f32, then timed in bf16 beside its plain version, SDPA with the
    same mask and its bound."""
    import torch.nn.functional as F

    d = 64
    timings = {}
    for seed, (label, b, h, hkv, sq, sk, causal, shift, window) in \
            enumerate(shapes):
        opts = dict(causal=causal, window=window, q_shift=shift)
        errs = mesh_hop_checks(torch, flash, smoke, label, b, h, hkv, sq, sk,
                               d, opts, seed0 + seed)
        q, k, v, dout = train_inputs(torch, b, h, hkv, sq, sk, d,
                                     torch.bfloat16, False, 41)
        out, lse = flash.flash_fwd_reference(q, k, v, **opts)
        args = (q, k, v, dout.contiguous(), lse,
                flash.attention_delta(out, dout))
        mask = {}
        if causal:
            rows = torch.arange(sq, device="cuda")[:, None] + shift
            cols = torch.arange(sk, device="cuda")[None, :]
            keep = cols <= rows
            if window is not None:
                keep = keep & (cols > rows - window)
            mask = dict(attn_mask=keep)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(
            qg, kg, vg, enable_gqa=hkv != h, **mask)

        def sdpa_backward():
            torch.autograd.grad(sdpa_out, (qg, kg, vg), args[3],
                                retain_graph=True)

        library_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=hkv != h, **mask), iters=10)
        library_bwd = time_ms(torch, sdpa_backward, iters=10)
        kernel = {
            "flash_fwd_lse": (lambda: flash.flash_fwd(q, k, v, need_lse=True,
                                                      **opts),
                              lambda: flash.flash_fwd_reference(q, k, v,
                                                                **opts),
                              library_fwd, "fwd_lse"),
            "flash_bwd_dq": (lambda: flash.flash_bwd_dq(*args, **opts),
                             lambda: flash.flash_bwd_dq_reference(*args,
                                                                  **opts),
                             library_bwd, "dq"),
            "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(*args, **opts),
                              lambda: flash.flash_bwd_dkv_reference(
                                  *args, **opts), library_bwd, "dkv"),
        }
        for name, (fn, plain, library, kind) in kernel.items():
            t = {"kernel_ms": time_ms(torch, fn, iters=10),
                 "plain_ms": time_ms(torch, plain, iters=10),
                 "library_ms": library,
                 "library_call": "F.scaled_dot_product_attention with the "
                 "hop's mask " + ("forward" if kind == "fwd_lse" else
                                  "backward alone (dq, dk and dv together)")}
            t["bound_ms"], t["bound_by"] = hop_bound_ms(
                b, h, hkv, sq, sk, d, causal, shift, window, kind)
            t["max_scaled_err"] = errs[name]
            timings.setdefault(name, {})[label] = t
            print(f"time {name} hop {label} (B={b}, H={h}, H_kv={hkv}, "
                  f"D={d}, bf16): kernel {t['kernel_ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, library {library:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
        del q, k, v, dout, qg, kg, vg, sdpa_out, args, out, lse
        torch.cuda.empty_cache()
    return timings


def hop_bound_ms(b, h, hkv, sq, sk, d, causal, shift, window, kind):
    """:func:`flash_bound_ms` of a rectangular hop: the live (row, key)
    pairs of its mask, each input read and each output written once."""
    n_q, n_kv, n_rows, products = BOUND_TERMS[kind]
    pairs = 0
    for r in range(sq):
        hi = min(sk, r + shift + 1) if causal else sk
        lo = max(0, r + shift - window + 1) if window else 0
        pairs += max(0, hi - lo)
    moved = (n_q * b * h * sq * d * 2 + n_kv * b * hkv * sk * d * 2
             + n_rows * b * h * sq * 4)
    ops = 2 * products * b * h * d * pairs
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mesh_phase(torch, flash, smoke: Smoke, power: str,
               launches: RankLaunches) -> dict:
    """Sequence and tensor parallelism on the card: (a) the hops and (b)
    the trainer over ranks, in one launch (beside the ``pipe`` and ``serve
    mesh`` launches); (d) the orbax refusal; then, once every launch is
    done, the kernels at the hop shapes, timed alone."""
    out = {"launches": {}}

    def beside() -> dict:
        launches.wait_all()
        return {name: launch.wall
                for name, launch in launches.launches.items()}

    for part, fn in (("ranks", lambda: mesh_ranks(torch, flash, smoke,
                                                  power, launches)),
                     ("orbax", lambda: mesh_orbax(torch, smoke)),
                     ("launches beside", beside),
                     ("hop timing", lambda: mesh_hop_timing(torch, flash,
                                                           smoke))):
        start = time.perf_counter()
        out[part] = fn()
        if "launches" in out[part]:
            out["launches"].update(out[part].pop("launches"))
        print(f"-- mesh {part}: {time.perf_counter() - start:.3f} s",
              flush=True)
    return out


PIPE_RANKS = 4
PIPE_TIMEOUT = 420  # seconds the launch of ranks may take
PIPE_TRAIN_STEPS = 3  # cut from 5 for the run's time limit
# the flagship GPT at S = 4096, B = 4 for the ring inside the stages
PIPE_GPT_S4096 = [*TRAIN_ARGS[:TRAIN_ARGS.index("--seq-len")], "--seq-len",
                  "4096", "--batch-size", "4", "--device", "cuda"]
PIPE_LLAMA_ARGS = [*LLAMA_TRAIN_ARGS, "--sliding-window", "512"]
PIPE_TRAIN_RUNS = [
    # (label, args, flags, pipeline flags, pipe, seq, model, microbatches,
    #  zigzag, steps); all over the PIPE_RANKS ranks, data parallel over
    # what the flags leave; the one-process run takes args + flags
    ("gpt-pp4-m8-gpipe", TRAIN_ARGS, [], ["--pipe-parallel", "4",
                                          "--pipe-microbatches", "8"],
     4, 1, 1, 8, False, PIPE_TRAIN_STEPS),
    ("gpt-pp4-m8-1f1b", TRAIN_ARGS, [], ["--pipe-parallel", "4",
                                         "--pipe-microbatches", "8",
                                         "--pipe-schedule", "1f1b"],
     4, 1, 1, 8, False, PIPE_TRAIN_STEPS),
    ("gpt-pp2-tp2-m4-1f1b", TRAIN_ARGS, [], [
        "--pipe-parallel", "2", "--model-parallel", "2", "--pipe-schedule",
        "1f1b", "--pipe-microbatches", "4"], 2, 1, 2, 4, False,
     PIPE_TRAIN_STEPS),
    ("gpt-pp2-sp2-1f1b-s4096", PIPE_GPT_S4096, [], [
        "--pipe-parallel", "2", "--seq-parallel", "2", "--pipe-schedule",
        "1f1b"], 2, 2, 1, 4, False, PIPE_TRAIN_STEPS),
    ("llama-pp2-dp2-m4-window512", PIPE_LLAMA_ARGS, [], [
        "--pipe-parallel", "2", "--pipe-microbatches", "4"], 2, 1, 1, 4,
     False, PIPE_TRAIN_STEPS),
    # (b) short runs: the flagship GPT cut to 4 layers, 3 steps
    ("gpt4-pp2-sp2-zigzag-1f1b", SHORT_TRAIN_ARGS, [], [
        "--pipe-parallel", "2", "--seq-parallel", "2", "--zigzag",
        "--pipe-schedule", "1f1b"], 2, 2, 1, 4, True, 3),
    # experts split by ff column over model: each microbatch routes its
    # 2 rows as one group of 4096 tokens, as one process does
    ("gpt4-moe-pp2-tp2", SHORT_TRAIN_ARGS, ["--moe"], [
        "--pipe-parallel", "2", "--model-parallel", "2"], 2, 1, 2, 4, False,
     3),
    ("gpt4-lora8-pp2-dp2", SHORT_TRAIN_ARGS, ["--lora-rank", "8"],
     ["--pipe-parallel", "2"], 2, 1, 1, 4, False, 3),
]
# the pipeline run's first two losses against one process's on the same
# seed, tokens and weights (bf16): the stages hand on bf16 activations
# where one process's next norm reads the fp32 residual sum, and the
# microbatches' gradients sum in another order.  The readings on the H100
# (PERF.md): dense runs up to 9.0e-5 and 1.9e-4, so the limits are
# ten times those; the MoE run has its own, five and four times its
# 1.8e-4 and 1.3e-2 (a bf16 router logit that rounds the other way sends
# a token to another expert)
PIPE_LOSS_TOL = {"dense": (1e-3, 2e-3), "moe": (1e-3, 5e-2)}
PIPE_DIR = Path("build") / "chip_smoke" / "pipe"
# the stage shapes the runs of (a) launch that the mesh's hop rows do not
# cover: (label, B, H, H_kv, S_q, S_k, causal, q_shift, window)
PIPE_STAGE_SHAPES = [
    ("gpt-stage-1x16x2048", 1, 16, 16, 2048, 2048, True, 0, None),
    ("gpt-stage-ring-earlier-1x16x2048", 1, 16, 16, 2048, 2048, False, 0,
     None),
    ("gpt-stage-tp2-2x8x2048", 2, 8, 8, 2048, 2048, True, 0, None),
    ("llama-stage-gqa-window512-1x16x4x2048", 1, 16, 4, 2048, 2048, True, 0,
     512),
]


def pipe_rank_main(argv: list[str]) -> int:
    """``chip_smoke.py --pipe-rank OUT``: the rank side of the ``pipe``
    phase, under ``torch.distributed.run``: each trainer run of
    :data:`PIPE_TRAIN_RUNS`, in one process group."""
    exit_with_owner()
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(argv[0])
    distributed.initialize_from_env(device="cuda")
    for label, base, flags, meshed, pipe, sp, tp, *_, steps in \
            PIPE_TRAIN_RUNS:
        extra = (["--checkpoint-dir", str(out / label), "--checkpoint-every",
                  "0"] if tp > 1 and not flags else [])
        mesh_train_rank(torch, out, label, [
            *base, *flags, "--log-every", "1", "--overfit", *meshed, *extra,
            "--steps", str(steps)], keep_params=bool(extra))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def pipe_lora_one_process(torch, argv: list[str], micro: int) -> dict:
    """One process's first two steps of a pipelined LoRA run: the same
    stage-stacked base and adapters (the trainer's seeds), its step on one
    stage in this process, on the trainer's first batch.  (A flat LoRA run
    adapts the fused projections with other factors, so it is another
    model after its first update.)"""
    from kube_sqs_autoscaler_tpu_torch.workloads import (
        lora, pipeline, train, trainer,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.data import (
        synthetic_token_stream,
    )

    args = trainer.build_parser().parse_args(
        [*argv, "--pipe-parallel", "2"])
    tcfg = train.TrainConfig(learning_rate=args.learning_rate)
    config, _, base, _ = trainer.build_model(args, "cuda", tcfg)
    mesh = pipeline.make_pipeline_mesh(1, device="cuda")
    lcfg = lora.LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha)
    full = lora.init_pipeline_lora_train_state(
        torch.Generator().manual_seed(args.seed + 1), base, lcfg, tcfg)
    state = lora.place_pipeline_lora_state(mesh, full)
    step_fn = lora.make_lora_pipeline_train_step(
        mesh, config, pipeline.PipelineConfig(micro), tcfg,
        pipeline.shard_pipeline_params(base, mesh), lcfg)
    batch = next(synthetic_token_stream(config.vocab_size, args.batch_size,
                                        args.seq_len, seed=args.seed))
    tokens = torch.from_numpy(np.ascontiguousarray(pipeline.pipeline_rows(
        batch, mesh, micro))).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(2):
        start = time.perf_counter()
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))  # the sync point
    # the second step's wall time: the first pays the one-time costs
    return {"losses": losses, "step_ms": (time.perf_counter() - start) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def pipe_one_process(torch, flash) -> dict:
    """One process's first two steps of each run's flags without the
    pipeline flags: the losses the pipeline's first two steps must equal,
    its step time and peak memory (the LoRA run's through one stage,
    :func:`pipe_lora_one_process`)."""
    out = {}
    for _, base, flags, _, _, _, _, micro, *_ in PIPE_TRAIN_RUNS:
        key = tuple(base + flags)
        if key in out:
            continue
        if "--lora-rank" in flags:
            out[key] = pipe_lora_one_process(torch, [*base, *flags], micro)
            continue
        run = trainer_run(torch, flash, [*base, *flags, "--log-every", "1",
                                         "--overfit", "--steps", "2"])
        summary = run["summary"]
        out[key] = {"losses": summary["losses"],
                    "step_ms": 1e3 / summary["steps_per_s"],
                    "peak_gib": run["peak_gib"]}
        del run, summary
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_pipe_training(torch, smoke: Smoke, out: Path, power: str,
                        one: dict) -> dict:
    """(a) and (b): each run's first two losses against one process's,
    falling losses, each rank's exact launches a step (``n_layers / P``
    layers x ``M`` microbatches x its ring hops), step time and per-rank
    peak memory; 1F1B's peak below GPipe's at ``M = 8``; the pp x tp
    checkpoint served by the single-card worker."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        load_model_layout, load_model_manifest,
    )

    result = {"launches": {}, "runs": {}}
    for label, base, flags, _, pipe, sp, tp, micro, zz, steps in \
            PIPE_TRAIN_RUNS:
        files = [out / f"{label}-rank{r}.json" for r in range(PIPE_RANKS)]
        if not all(f.exists() for f in files):
            smoke.check(False, f"pipe {label}: a rank wrote no result")
            continue
        ranks = [json.loads(f.read_text()) for f in files]
        losses = ranks[0]["losses"]
        single = one[tuple(base + flags)]
        tols = PIPE_LOSS_TOL["moe" if "--moe" in flags else "dense"]
        diffs = [abs(a - b) for a, b in zip(losses, single["losses"])]
        smoke.check(
            len(diffs) == 2
            and all(dd <= tol for dd, tol in zip(diffs, tols))
            and all(r["losses"] == losses for r in ranks),
            f"pipe {label}: the first two losses "
            f"{[round(x, 6) for x in losses[:2]]} vs one process's "
            f"{[round(x, 6) for x in single['losses']]} (|d| "
            f"{[f'{dd:.2e}' for dd in diffs]}, tol {list(tols)}: bf16, "
            "summed in another order); every rank reports the same losses")
        smoke.check(len(losses) == steps
                    and all(map(math.isfinite, losses))
                    and losses[-1] < losses[0],
                    f"pipe {label}: {steps} losses, finite and "
                    f"falling: {[round(x, 4) for x in losses]}")
        layers = int(base[base.index("--n-layers") + 1])
        seq = int(base[base.index("--seq-len") + 1])
        window = (int(base[base.index("--sliding-window") + 1])
                  if "--sliding-window" in base else None)
        total = {}
        for r in ranks:
            me = (r["rank"] // tp) % sp
            n = hop_launches("zigzag" if zz else "ring", sp, me, seq // sp,
                             window) * (layers // pipe) * micro * steps
            want = {"flash_fwd": 0, "flash_fwd_lse": n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
            smoke.check(r["launches"] == want,
                        f"pipe {label} rank {r['rank']} (stage "
                        f"{r['rank'] // (PIPE_RANKS // pipe)}, seq {me}): "
                        f"launches {r['launches']}, want {want}")
            for name, value in r["launches"].items():
                total[name] = total.get(name, 0) + value
        result["launches"][f"pipe-train-{label}"] = total
        step_ms = 1e3 / ranks[0]["steps_per_s"]
        peaks = [round(r["peak_gib"], 3) for r in ranks]
        print(f"pipe train {label}: steady step {step_ms:.3f} ms, "
              f"{ranks[0]['tokens_per_s']:.1f} tokens/s, per-rank peak "
              f"memory {peaks} GiB; one process's step "
              f"{single['step_ms']:.3f} ms, peak "
              f"{single['peak_gib']:.3f} GiB "
              f"({PIPE_RANKS} ranks sharing one {power}, over gloo)",
              flush=True)
        result["runs"][label] = {"step_ms": step_ms, "peak_gib": peaks,
                                 "losses": losses,
                                 "one_losses": single["losses"],
                                 "loss_diffs": diffs,
                                 "tokens_per_s": ranks[0]["tokens_per_s"]}
        if tp > 1 and not flags:
            ckpt = out / label
            family, config = load_model_manifest(ckpt)
            layout = load_model_layout(ckpt)
            args = ["--demo", "16", "--batch-size", "8", "--seq-len", "512",
                    "--generate-tokens", "16", "--result-queue-url",
                    "demo://replies", "--device", "cuda"]
            served = worker.main([*args, "--checkpoint-dir", str(ckpt)])
            params = torch.load(out / f"{label}-params.pt",
                                map_location="cuda", weights_only=True)
            service_config = worker.ServiceConfig(
                queue_url="", batch_size=8, seq_len=512, generate_tokens=16,
                result_queue_url="demo://replies")
            direct = worker.run_demo(16, params, config, service_config,
                                     torch.device("cuda"))
            same = replies_of(served) == replies_of(direct)
            smoke.check(same and len(served["replies"]) == 16
                        and layout == {"kind": "pipeline",
                                       "n_stages": pipe},
                        f"pipe {label}: the single-card worker's "
                        f"{len(served['replies'])} replies from the "
                        f"pipeline checkpoint (layout {layout}, {family}) "
                        "equal serving the ranks' gathered parameters")
            del params
    runs = result["runs"]
    gpipe, one_f = runs.get("gpt-pp4-m8-gpipe"), runs.get("gpt-pp4-m8-1f1b")
    if gpipe and one_f:
        smoke.check(max(one_f["peak_gib"]) < max(gpipe["peak_gib"])
                    and all(a < b for a, b in zip(one_f["peak_gib"],
                                                  gpipe["peak_gib"])),
                    f"pipe memory at M=8, P=4: 1F1B per-rank peaks "
                    f"{one_f['peak_gib']} GiB below GPipe's "
                    f"{gpipe['peak_gib']} GiB")
    return result


def pipe_ranks(torch, flash, smoke: Smoke, power: str,
               launches: RankLaunches) -> dict:
    """(a) and (b): one launch of :data:`PIPE_RANKS` ranks runs every
    trainer run (started by the ``mesh`` phase, beside its own); this
    process checks what they wrote."""
    if "pipe" not in launches.one_process:
        launches.one_process["pipe"] = pipe_one_process(torch, flash)
    one = launches.one_process["pipe"]
    out = PIPE_DIR / "ranks"
    log = PIPE_DIR / "ranks.log"
    rc, wall = launches.launches["pipe"].wait()
    smoke.check(rc == 0, f"pipe: {PIPE_RANKS} ranks exited "
                f"{'on a timeout' if rc is None else rc} after {wall:.1f} s")
    if rc != 0:
        print(log.read_text()[-6000:], flush=True)
    result = {"wall_s": wall, "one_process": {
        " ".join(k): v for k, v in one.items()}}
    train = check_pipe_training(torch, smoke, out, power, one)
    result["launches"] = train.pop("launches")
    result["training"] = train
    return result


def pipe_phase(torch, flash, smoke: Smoke, power: str,
               launches: RankLaunches) -> dict:
    """Pipeline parallelism on the card: (a) and (b) the trainer over
    ranks through GPipe and 1F1B, in one launch; (c) the training kernels
    at the stage shapes, checked and timed alone."""
    out = {"launches": {}}
    for part, fn in (("ranks", lambda: pipe_ranks(torch, flash, smoke,
                                                  power, launches)),
                     ("stage timing", lambda: hop_timing(
                         torch, flash, smoke, PIPE_STAGE_SHAPES, 400))):
        start = time.perf_counter()
        out[part] = fn()
        if "launches" in out[part]:
            out["launches"].update(out[part].pop("launches"))
        print(f"-- pipe {part}: {time.perf_counter() - start:.3f} s",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# serve mesh: serving over a (data, model) mesh of ranks sharing the card
# ---------------------------------------------------------------------------

SERVE_MESH_RANKS = 4
SERVE_MESH_TIMEOUT = 420  # seconds the launch of ranks may take
SERVE_MESH_DIR = Path("build") / "chip_smoke" / "serve_mesh"
SERVE_MESH_FEW = 8  # the reduced runs' bodies: one batch
SERVE_MESH_B8 = ["--continuous", "--decode-block", "8"]


def serve_mesh_few(flags: list[str]) -> list[str]:
    """A reduced run's flags: 8 tokens a reply, cut from 32 for the run's
    time limit."""
    flags = list(flags)
    flags[flags.index("--generate-tokens") + 1] = "8"
    return flags


SERVE_MESH_RUNS = [
    # (label, worker flags, --model-parallel, bodies); every run over the
    # SERVE_MESH_RANKS ranks, data parallel over what the model axis
    # leaves; the one-process run takes the same flags without the mesh
    # the full-width runs cut from 64 bodies for the run's time limit (over
    # gloo a token of 8 rows costs 40-115 ms) to 24: three batches, three
    # fills of the 8 slots
    ("gpt-mp2-batch", GENERATE_ARGS, 2, 24),
    ("gpt-mp2-continuous-b8", [*GENERATE_ARGS, *SERVE_MESH_B8], 2, 24),
    ("gpt-mp4-batch", GENERATE_ARGS, 4, 24),
    ("gpt-mp4-continuous-b8", [*GENERATE_ARGS, *SERVE_MESH_B8], 4, 24),
    ("llama-mp2-continuous-b8", [*LLAMA_ARGS, *SERVE_MESH_B8], 2, 24),
    # reduced: one batch of bodies each, 8 tokens a reply (the beam run
    # 32)
    ("gpt-mp2-quantize-kv", serve_mesh_few([*GENERATE_ARGS, *SERVE_MESH_B8,
                                            "--quantize-kv"]), 2,
     SERVE_MESH_FEW),
    ("gpt-mp2-prefix", serve_mesh_few([*GENERATE_ARGS, *SERVE_MESH_B8,
                                       *PREFIX_ARGS]), 2, SERVE_MESH_FEW),
    ("gpt-mp2-beams2", [*GENERATE_ARGS, "--beams", "2"], 2, SERVE_MESH_FEW),
    ("gpt-mp2-speculative", serve_mesh_few([*GENERATE_ARGS, *SPEC_ARGS]), 2,
     SERVE_MESH_FEW),
    ("gpt-mp2-tenants-pool", serve_mesh_few([
        *GENERATE_ARGS, *SERVE_MESH_B8, "--tenants", "a,b",
        "--prefix-pool", "8"]), 2, SERVE_MESH_FEW),
    ("gpt-mp2-shards4", serve_mesh_few([*GENERATE_ARGS, *SERVE_MESH_B8,
                                        "--shards", "4"]), 2,
     SERVE_MESH_FEW),
    ("gpt-mp2-classify", CLASSIFY_ARGS, 2, SERVE_MESH_FEW),
    # the fleet over the mesh: 64 bodies, so that replicas spawn, turn
    # their slots over and drain (8 tokens a reply, for the time limit)
    ("gpt-mp2-fleet", serve_mesh_few([*GENERATE_ARGS, *SERVE_MESH_B8,
                                      "--fleet-max-replicas", "3"]), 2, 64),
]
# bf16 replies of the mesh that differ from one process's must first differ
# at a near-tie: one process's top-two margin there below this (a beam
# search's: its margin over the mesh's reply, :func:`beam_drop_margin`)
SERVE_MESH_TIE = 2e-2
# the forward kernel at the ranks' shapes: (label, B, H, H_kv, S); the
# GPT's 8 heads over tp 2 or 4, its batch of 8 over dp 2 (a generate
# batch's prompt pass), an insert's rows on every data rank, the llama's
# 2 kv heads over tp 2 (GQA at one kv head a rank)
SERVE_MESH_SHAPES = [
    ("gpt-dp2-tp2-prefill", 4, 4, 4, 512),
    ("gpt-tp4-prefill", 8, 2, 2, 512),
    ("classify-dp2-tp2", 4, 4, 4, 1024),
    ("insert-tp2-8", 8, 4, 4, 512),
    ("insert-tp2-1", 1, 4, 4, 512),
    ("insert-tp4-1", 1, 2, 2, 512),
    ("plane-insert-tp2-32", 32, 4, 4, 512),
    ("llama-tp2-gqa-kv1-8", 8, 4, 1, 512),
    ("llama-tp2-gqa-kv1-1", 1, 4, 1, 512),
]


def serve_mesh_argv(flags: list[str], bodies: int) -> list[str]:
    argv = list(flags)
    argv[argv.index("--demo") + 1] = str(bodies)
    return [*argv, "--device", "cuda"]


def serve_mesh_expected(label: str, flags: list[str], bodies: int,
                        summary: dict) -> int:
    """The forward launches (no lse) one rank makes in a run: the model's
    4 layers once a prompt pass.  Each batch of 8 bodies is one prompt
    pass (speculative: the target's and the 2-layer draft's), each insert
    of the continuous engine one (every data rank prefills it); the shared
    prefix is prefilled once, its suffix inserts run the chunk decoder."""
    batches = -(-bodies // 8)
    if "--prefix-ids" in flags:
        return SERVE_LAYERS
    if "--continuous" in flags:
        return SERVE_LAYERS * summary["insert_dispatches"]
    if "--speculative-draft-layers" in flags:
        return (SERVE_LAYERS + SPEC_DRAFT) * batches
    return SERVE_LAYERS * batches


def serve_mesh_f32(torch, mesh=None) -> dict:
    """The built-in GPT at full width in f32, served over ``mesh`` (or by
    one process): ``generate`` of the first 8 demo prompts through the
    family's serving functions, and the continuous engine at block 8 over
    the same prompts.  Returns both sets of tokens, and the engine's
    cache: its rows, heads and KV bytes (on a mesh, the rank's)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import continuous, decode
    from kube_sqs_autoscaler_tpu_torch.workloads import train

    config, params, model = f32_model(torch, "gpt")
    prompts = torch.tensor([json.loads(b) for b in demo_bodies(8)],
                           device="cuda")
    lengths = torch.full((8,), 512, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        if mesh is None:
            tokens = decode.generate(
                params, prompts, 32, config, lengths=lengths,
                attention_fn=model.attention_fn_for(config, 512, "cuda"))
        else:
            params = train.shard_params(params, mesh)
            _, _, gen = decode.make_serving_fns(mesh, config, params)
            tokens = gen(params, prompts, None, lengths, 32)
        batcher = continuous.ContinuousBatcher(
            params, config, batch_size=8, prompt_len=512, generate_tokens=32,
            decode_block=8, mesh=mesh, device="cuda")
        for i, row in enumerate(prompts.cpu().numpy()):
            batcher.submit(row, payload=i)
        slots = {}
        while batcher.active:
            slots.update(dict(batcher.step()))
    first = batcher.cache["layers"][0]["k"]
    return {"generate": tokens.cpu(),
            "continuous": torch.tensor(np.stack([np.asarray(slots[i])
                                                 for i in range(8)])),
            "cache": {"rows": first.shape[0], "heads": first.shape[1],
                      "bytes": sum(buf.numel() * buf.element_size()
                                   for layer in batcher.cache["layers"]
                                   for buf in layer.values())}}


# the fleet over the mesh, beside the binary's --fleet-max-replicas run of
# SERVE_MESH_RUNS: the fleet phase's FakeClock episode and a
# ShardedWorkerPool's 4-shard plane under the same control loop, the
# built-in GPT at full width, bf16; (bodies, tokens a reply, kill, hang).
# The pool's faults land on busy replicas at 16 tokens a reply (cut from
# 32 for the run's time limit): replica 1 killed at cycle 5, replica 2 hung
# at cycle 10, each holding 8 requests (host dynamics: the same at any
# width, rehearsed on the CPU)
SERVE_MESH_FLEET = {"pool": (64, 16, (5, 1), (10, 2)),
                    "sharded": (40, 8, None, None)}


def sharded_fleet_episode(torch, params, config, device="cuda", mesh=None,
                          bodies=24, tokens=8) -> dict:
    """``ShardedWorkerPool.serving(min=1, max=4)``: 4 shards of 8 slots
    behind one admission plane, under the binary's fleet loop on a
    ``FakeClock`` (two cycles a poll), every body queued at the start;
    until every body is answered and the plane is back at one shard.  On
    a ``mesh`` the plane holds the rank's rows and heads and the loop
    reads world rank 0's queue."""
    from kube_sqs_autoscaler_tpu_torch.core import (
        ControlLoop, FakeClock, LoopConfig,
    )
    from kube_sqs_autoscaler_tpu_torch.fleet import (
        FleetDriver, ShardedWorkerPool,
    )
    from kube_sqs_autoscaler_tpu_torch.metrics import QueueMetricSource
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

    clock = FakeClock()
    queue = FakeMessageQueue(visibility_timeout=30.0, now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    sent = [queue.send_message(FLEET_QUEUE, body)
            for body in demo_bodies(bodies, config.vocab_size)]
    service_config = ServiceConfig(
        queue_url=FLEET_QUEUE, batch_size=8, seq_len=512,
        generate_tokens=tokens, decode_block=8,
        result_queue_url=FLEET_RESULTS, shards=4)
    pool = ShardedWorkerPool.serving(
        queue, params, config, service_config, result_queue=results, min=1,
        max=4, clock=clock, now_fn=clock.now, device=device, mesh=mesh)
    depth = queue
    if mesh is not None:
        from kube_sqs_autoscaler_tpu_torch.workloads.distributed import (
            RankQueue,
        )

        depth = RankQueue(queue)
    loop = ControlLoop(
        pool,
        QueueMetricSource(depth, FLEET_QUEUE, ("ApproximateNumberOfMessages",)),
        LoopConfig(poll_interval=0.1, policy=fleet_gates()), clock=clock)
    stats = FleetDriver(pool, loop, cycle_dt=0.05).run(
        max_cycles=3000, until=lambda: (
            pool.processed >= len(sent) and pool.idle
            and pool.replicas == pool.min))
    return {"pool": pool, "stats": stats, "sent": sent, "queue": queue,
            "replies": drain_raw(results, FLEET_RESULTS)}


def serve_mesh_fleet(torch, flash, mesh=None, device="cuda") -> dict:
    """The episodes of :data:`SERVE_MESH_FLEET` over ``mesh`` (or by one
    process): each one's sent ids, replies (world rank 0's), replica
    trajectory, pool events (times on its ``FakeClock``), this rank's
    forward launches and its replicas' inserts."""
    from kube_sqs_autoscaler_tpu_torch.workloads import train

    config, params, _ = demo_setup(torch, GENERATE_ARGS)
    if mesh is not None:
        params = train.shard_params(params, mesh)
    out = {}
    for name, (bodies, tokens, kill, hang) in SERVE_MESH_FLEET.items():
        zero_counts(flash)
        if name == "pool":
            run = fleet_episode(torch, params, config, device=device,
                                mesh=mesh, bodies=bodies, tokens=tokens,
                                kill=kill, hang=hang)
        else:
            run = sharded_fleet_episode(torch, params, config, device=device,
                                        mesh=mesh, bodies=bodies,
                                        tokens=tokens)
        if device == "cuda":
            torch.cuda.synchronize()
        pool = run["pool"]
        out[name] = {
            "sent": run["sent"], "replies": run["replies"],
            "trajectory": run["stats"]["replica_trajectory"],
            "events": [[e.name, e.t, e.args] for e in pool.events],
            "launches": counts(flash)["flash_fwd"],
            "inserts": sum(w.batcher.insert_dispatches for w in (
                [r.worker for r in pool.members] if name == "pool"
                else [pool.worker])),
            "queue": run["queue"].get_queue_attributes(FLEET_QUEUE, ())}
        del run, pool
        gc.collect()
    return out


def serve_mesh_rank_main(argv: list[str]) -> int:
    """``chip_smoke.py --serve-mesh-rank OUT``: the rank side of the
    ``serve mesh`` phase, under ``torch.distributed.run``: each worker
    binary run of :data:`SERVE_MESH_RUNS` with ``--model-parallel``, then
    the f32 serving functions, in one process group."""
    exit_with_owner()
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed, flash
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker_main,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(argv[0])
    started = time.perf_counter()
    distributed.initialize_from_env(device="cuda")
    rank = dist.get_rank()
    for label, flags, tp, bodies in SERVE_MESH_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        zero_counts(flash)
        decoded = decode_attention_count()
        start = time.perf_counter()
        summary = worker_main([*serve_mesh_argv(flags, bodies),
                               "--model-parallel", str(tp)])
        torch.cuda.synchronize()
        (out / f"{label}-rank{rank}.json").write_text(json.dumps({
            "rank": rank, "launches": counts(flash),
            # the cached decode attention kernel, at this rank's heads
            "decode_attention": decode_attention_count() - decoded,
            # the run's wall time, the binary's start-up included, and
            # this process's since it joined the group
            "wall_s": time.perf_counter() - start,
            "since_start_s": time.perf_counter() - started,
            "summary": {key: summary.get(key) for key in (
                "processed", "replies", "duplicate_replies", "msgs_per_s",
                "tokens_per_s", "elapsed_s", "generated_tokens",
                "insert_dispatches", "decode_dispatches", "mesh",
                "replica_trajectory")}}))
        del summary
    serving = distributed.make_mesh(model_parallel=2, device="cuda")
    start = time.perf_counter()
    fleet = serve_mesh_fleet(torch, flash, serving)
    (out / f"fleet-rank{rank}.json").write_text(json.dumps({
        **fleet, "wall_s": time.perf_counter() - start}))
    f32 = serve_mesh_f32(torch, serving)
    if rank == 0:
        torch.save(f32, out / "f32.pt")
    (out / f"f32-cache-rank{rank}.json").write_text(json.dumps(f32["cache"]))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def serve_mesh_one_process(torch, flash) -> dict:
    """Each run's flags without the mesh, in this process: the replies,
    rates and launches the mesh run is held to."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker_main,
    )

    out = {}
    for label, flags, _, bodies in SERVE_MESH_RUNS:
        zero_counts(flash)
        summary = worker_main(serve_mesh_argv(flags, bodies))
        torch.cuda.synchronize()
        out[label] = {"replies": summary["replies"],
                      "launches": counts(flash)["flash_fwd"],
                      **{key: summary.get(key) for key in (
                          "msgs_per_s", "tokens_per_s", "elapsed_s",
                          "generated_tokens", "replica_trajectory")}}
        del summary
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_mesh_margin(torch, label: str, flags: list[str], body: str,
                      tokens: list[int], at: int, models: dict,
                      mesh_tokens: list[int] | None = None) -> float:
    """One process's margin where the mesh's reply (``mesh_tokens``) first
    differs from its own (position ``at`` of its ``tokens``), on the
    family's dense forward over the prompt (the shared prefix first, where
    there is one): greedy decoding's top-two margin there, given the
    tokens before it; for a beam search, :func:`beam_drop_margin` of the
    mesh's reply."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
    from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

    if label not in models:
        # the model the binary built for these flags (its context, hence
        # its seeded weights, depends on the prefix, pool and draft)
        args = binary.build_parser().parse_args(serve_mesh_argv(flags, 8))
        config, layout, params = binary.served_model(
            args, len(PREFIX_IDS) if args.prefix_ids else 0,
            args.seq_len if args.prefix_pool else 0,
            2 * args.speculative_draft_tokens
            if args.speculative_draft_layers else 0)
        models[label] = (config, binary.served_params(
            args, config, layout, params, torch.device("cuda")))
    config, params = models[label]
    prompt = json.loads(body)
    if "--prefix-ids" in flags:
        prompt = PREFIX_IDS + prompt
    forward = family_of(config).forward
    if "--beams" in flags:
        assert "--length-penalty" not in flags and "--eos-id" not in flags
        with torch.inference_mode():
            return beam_drop_margin(
                torch, forward, params, config, prompt, mesh_tokens,
                int(flags[flags.index("--beams") + 1]))
    ids = torch.tensor(prompt + tokens[:at], device="cuda")
    with torch.inference_mode():
        margins = greedy_margins(
            torch, params, config, ids[:len(prompt)],
            torch.tensor(tokens[:at + 1], device="cuda"), forward)
    return float(margins[at])


def beam_drop_margin(torch, forward, params, config, prompt: list[int],
                     reply: list[int], width: int,
                     device: str = "cuda") -> float:
    """How narrowly one process's beam search of ``width`` beams (no eos,
    no length penalty), replayed on the dense ``forward``, passes over
    ``reply``: at the step where it drops a prefix of ``reply``, the
    joint log-probability of the last candidate it keeps less that
    prefix's; if it keeps ``reply`` to the end, the best final beam's less
    ``reply``'s (0 when ``reply`` is its answer)."""
    beams, scores = [[]], torch.zeros(1, device=device)
    for t in range(len(reply)):
        seqs = torch.tensor([prompt + b for b in beams], device=device)
        logp = forward(params, seqs, config)[:, -1].float().log_softmax(-1)
        vocab = logp.shape[-1]
        candidates = (scores[:, None] + logp).flatten()
        top = candidates.topk(width)
        mine = candidates[beams.index(reply[:t]) * vocab + reply[t]]
        kept = [beams[i // vocab] + [i % vocab] for i in top.indices.tolist()]
        if reply[:t + 1] not in kept:
            return float(top.values[-1] - mine)
        beams, scores = kept, top.values
    return float(scores[0] - scores[beams.index(reply)])


def check_serve_mesh(torch, smoke: Smoke, out: Path, one: dict,
                     power: str) -> dict:
    """Every body answered once, by rank 0; bf16 replies against one
    process's up to near-ties; each rank's exact forward launches; the
    rates beside one process's (not gated: the ranks' collectives go
    through host memory)."""
    result, launches, decode_launches, models = {}, {}, {}, {}
    for label, flags, tp, bodies in SERVE_MESH_RUNS:
        files = [out / f"{label}-rank{r}.json"
                 for r in range(SERVE_MESH_RANKS)]
        if not all(f.exists() for f in files):
            smoke.check(False, f"serve mesh {label}: every rank wrote its "
                        "result")
            continue
        ranks = [json.loads(f.read_text()) for f in files]
        lead = ranks[0]["summary"]
        smoke.check(
            all(r["summary"]["processed"] == bodies for r in ranks)
            and len(lead["replies"]) == bodies
            and lead["duplicate_replies"] == 0
            and all(not r["summary"]["replies"] for r in ranks[1:]),
            f"serve mesh {label} (--model-parallel {tp}, mesh "
            f"{lead['mesh']}): {len(lead['replies'])} of {bodies} bodies "
            f"answered once, by rank 0 alone")
        if "--fleet-max-replicas" in flags:
            trajectories = [r["summary"]["replica_trajectory"]
                            for r in ranks]
            smoke.check(
                all(t == trajectories[0] for t in trajectories)
                and max(trajectories[0], default=0) >= 2,
                f"serve mesh {label}: every rank took the same scaling "
                f"decisions on rank 0's clock and queue depth, replicas "
                f"{trajectories[0]} (one process on its own clock: "
                f"{one[label].get('replica_trajectory')})")
        want = one[label]["replies"]
        bodies_of = demo_bodies(bodies, seq_len=int(
            flags[flags.index("--seq-len") + 1]))
        same, near, far = 0, [], []
        for rid, reply in lead["replies"].items():
            base = want.get(rid)
            if reply == base:
                same += 1
                continue
            got_t = reply.get("tokens", [reply.get("next_token")])
            want_t = base.get("tokens", [base.get("next_token")])
            at = next(i for i, (a, b) in enumerate(zip(got_t, want_t))
                      if a != b)
            margin = serve_mesh_margin(
                torch, label, flags, bodies_of[int(rid.split("-")[1]) - 1],
                want_t, at, models, got_t)
            (near if margin < SERVE_MESH_TIE else far).append(
                (rid, at, margin))
        measure = ("beam drop margin" if "--beams" in flags
                   else "top-two margin")
        smoke.check(not far, f"serve mesh {label}: {same} of {bodies} bf16 "
                    f"replies equal one process's; {len(near)} differ, each "
                    f"first at a near-tie of one process's ({measure} "
                    f"< {SERVE_MESH_TIE:g}): {near[:4]}; beyond a near-tie: "
                    f"{far[:4]}")
        expected = serve_mesh_expected(label, flags, bodies, lead)
        got = [r["launches"] for r in ranks]
        smoke.check(
            all(g["flash_fwd"] == expected and g["flash_fwd_lse"] == 0
                and g["flash_bwd_dq"] == 0 and g["flash_bwd_dkv"] == 0
                for g in got),
            f"serve mesh {label}: each rank launched flash_fwd "
            f"{[g['flash_fwd'] for g in got]} times (want {expected}: "
            f"{SERVE_LAYERS} layers a prompt pass) and no training kernel; "
            f"one process {one[label]['launches']}")
        launches[f"serve-mesh-{label}"] = sum(g["flash_fwd"] for g in got)
        decode_launches[f"serve-mesh-{label}"] = sum(
            r["decode_attention"] for r in ranks)
        step_ms = (1e3 * lead["elapsed_s"] / (lead["generated_tokens"] / 8)
                   if lead.get("generated_tokens") else None)
        print(f"serve mesh {label}: rank 0's run {ranks[0]['wall_s']:.3f} s "
              f"of wall (drain {lead['elapsed_s']:.3f} s), "
              f"{ranks[0]['since_start_s']:.3f} s since it joined",
              flush=True)
        one_step = (1e3 * one[label]["elapsed_s"]
                    / (one[label]["generated_tokens"] / 8)
                    if one[label].get("generated_tokens") else None)
        result[label] = {
            "mesh": lead["mesh"], "same": same, "near_ties": near,
            "msgs_per_s": lead["msgs_per_s"],
            "tokens_per_s": lead["tokens_per_s"],
            "ms_per_8_tokens": step_ms,
            "one_process": {"msgs_per_s": one[label]["msgs_per_s"],
                            "tokens_per_s": one[label]["tokens_per_s"],
                            "ms_per_8_tokens": one_step},
        }
        print(f"rate serve mesh {label} ({power}): mesh "
              f"{lead['msgs_per_s']:.2f} msgs/s, {lead['tokens_per_s']:.1f} "
              f"tokens/s, {step_ms} ms a token of 8 rows; one process "
              f"{one[label]['msgs_per_s']:.2f} msgs/s, "
              f"{one[label]['tokens_per_s']:.1f} tokens/s, {one_step} ms "
              "(gloo stages every collective through host memory)",
              flush=True)
    result["launches"] = launches
    result["decode_launches"] = decode_launches
    return result


def check_serve_mesh_fleet(torch, smoke: Smoke, out: Path, one: dict,
                           power: str) -> dict:
    """The fleet episodes over the mesh against one process's
    (:data:`SERVE_MESH_FLEET`): every body answered once, by rank 0;
    every rank's replica trajectory and pool events (their times on the
    ``FakeClock``, kills and hangs with their re-dispatch) those of one
    process; bf16 replies equal one process's up to near-ties; each
    rank's forward launches 4 x its replicas' inserts."""
    files = [out / f"fleet-rank{r}.json" for r in range(SERVE_MESH_RANKS)]
    if not all(f.exists() for f in files):
        smoke.check(False, "serve mesh fleet: every rank wrote its result")
        return {"launches": {}}
    ranks = [json.loads(f.read_text()) for f in files]
    result, launches, models = {}, {}, {}
    for name, (bodies, tokens, kill, hang) in SERVE_MESH_FLEET.items():
        got = [r[name] for r in ranks]
        base = one[name]
        lead = got[0]
        duplicates = sum(len(v) - 1 for v in lead["replies"].values())
        smoke.check(
            sorted(lead["replies"]) == sorted(lead["sent"])
            == sorted(base["sent"]) and duplicates == 0
            and all(not g["replies"] for g in got[1:])
            and lead["queue"]["ApproximateNumberOfMessages"] == "0"
            and lead["queue"]["ApproximateNumberOfMessagesNotVisible"] == "0",
            f"serve mesh fleet {name}: {len(lead['replies'])} of {bodies} "
            f"bodies answered once, by rank 0 alone; its queue at the end "
            f"{lead['queue']}")
        events = [[e[0], e[1], e[2]] for e in base["events"]]
        smoke.check(
            all(g["events"] == events and g["trajectory"]
                == base["trajectory"] for g in got),
            f"serve mesh fleet {name}: every rank's trajectory "
            f"{lead['trajectory']} and its {len(lead['events'])} pool "
            f"events (times on the FakeClock, args) equal one process's")
        if kill is not None:
            kills = {e[2]["replica"]: e[2] for e in lead["events"]
                     if e[0] == "replica-kill"}
            smoke.check(
                kills.get(kill[1], {}).get("cause") == "killed"
                and kills[kill[1]].get("redispatched", 0) > 0
                and kills.get(hang[1], {}).get("cause") == "hung"
                and max(lead["trajectory"]) >= 3,
                f"serve mesh fleet {name}: replica {kill[1]} killed at "
                f"cycle {kill[0]} and replica {hang[1]} hung at cycle "
                f"{hang[0]}, their requests re-dispatched: {kills}")
        else:
            smoke.check(max(lead["trajectory"]) >= 2
                        and lead["trajectory"][-1] == 1,
                        f"serve mesh fleet {name}: the plane scaled its "
                        f"shards {lead['trajectory']}")
        prompts = dict(zip(base["sent"], demo_bodies(bodies)))
        same, near, far = 0, [], []
        for rid, (reply,) in lead["replies"].items():
            (want,) = base["replies"].get(rid, [None])
            if reply == want:
                same += 1
                continue
            got_t, want_t = (json.loads(reply)["tokens"],
                             json.loads(want)["tokens"])
            at = next(i for i, (a, b) in enumerate(zip(got_t, want_t))
                      if a != b)
            margin = serve_mesh_margin(torch, "fleet", GENERATE_ARGS,
                                       prompts[rid], want_t, at, models)
            (near if margin < SERVE_MESH_TIE else far).append(
                (rid, at, margin))
        smoke.check(not far, f"serve mesh fleet {name}: {same} of {bodies} "
                    f"bf16 replies equal one process's; {len(near)} differ, "
                    f"each first at a near-tie (< {SERVE_MESH_TIE:g}): "
                    f"{near[:4]}; beyond a near-tie: {far[:4]}")
        smoke.check(
            all(g["launches"] == SERVE_LAYERS * g["inserts"] for g in got)
            and base["launches"] == SERVE_LAYERS * base["inserts"],
            f"serve mesh fleet {name}: each rank launched flash_fwd "
            f"{[g['launches'] for g in got]} times = {SERVE_LAYERS} x its "
            f"replicas' inserts {[g['inserts'] for g in got]}; one process "
            f"{base['launches']} = {SERVE_LAYERS} x {base['inserts']}")
        launches[f"serve-mesh-fleet-{name}"] = sum(g["launches"]
                                                   for g in got)
        result[name] = {"trajectory": lead["trajectory"], "same": same,
                        "near_ties": near}
    print(f"serve mesh fleet episodes: rank 0's {ranks[0]['wall_s']:.3f} s "
          f"of wall ({power}; beside the mesh and pipe launches)",
          flush=True)
    result["launches"] = launches
    return result


def serve_mesh_kernels(torch, flash, smoke: Smoke) -> dict:
    """The forward kernel at every rank shape of :data:`SERVE_MESH_SHAPES`
    against its plain version in bf16 and f32, then timed beside its plain
    version, SDPA and its bound."""
    import torch.nn.functional as F

    timings, err = {}, 0.0
    for seed, (label, b, h, hkv, s) in enumerate(SERVE_MESH_SHAPES):
        for dtype_name in ("bfloat16", "float32"):
            q, k, v = make_qkv(torch, b, h, hkv, s, 64,
                               getattr(torch, dtype_name), True, 300 + seed)
            got = flash.flash_attention(q, k, v)
            want = flash.flash_attention_reference(q, k, v)
            e = (got.float() - want.float()).abs().max().item()
            smoke.check(bool(torch.isfinite(got).all().item())
                        and e <= TOL[dtype_name],
                        f"flash_fwd serve mesh {label} {dtype_name} B={b} "
                        f"H={h} H_kv={hkv} S={s} D=64: max|d|={e:.3e} "
                        f"tol={TOL[dtype_name]:g}")
            if dtype_name == "bfloat16":
                err = max(err, e)
        timings[label] = gqa_timing(torch, flash, F, (b, h, hkv, s, 64),
                                    None)
    return {"timings": timings, "err": err}


def serve_mesh_phase(torch, flash, smoke: Smoke, power: str,
                     launches: RankLaunches) -> dict:
    """Serving over a ``(data, model)`` mesh: one launch of
    :data:`SERVE_MESH_RANKS` ranks sharing the card over gloo (started by
    the ``mesh`` phase, beside its own) runs the worker binary with
    ``--model-parallel`` in every mode of :data:`SERVE_MESH_RUNS`, the
    fleet episodes and the f32 serving functions; this process runs the
    same flags and episodes alone and checks what the ranks wrote; then
    the forward kernel at the ranks' shapes."""
    out = SERVE_MESH_DIR / "ranks"
    log = SERVE_MESH_DIR / "ranks.log"
    rc, wall = launches.launches["serve mesh"].wait()
    start = time.perf_counter()
    one = serve_mesh_one_process(torch, flash)
    fleet_one = serve_mesh_fleet(torch, flash)
    f32_one = serve_mesh_f32(torch)
    print(f"-- serve mesh one process: {time.perf_counter() - start:.3f} s",
          flush=True)
    smoke.check(rc == 0, f"serve mesh: {SERVE_MESH_RANKS} ranks exited "
                f"{'on a timeout' if rc is None else rc} after {wall:.1f} s")
    if rc != 0:
        print(log.read_text()[-6000:], flush=True)
    result = {"wall_s": wall}
    result.update(check_serve_mesh(torch, smoke, out, one, power))
    fleet = check_serve_mesh_fleet(torch, smoke, out, fleet_one, power)
    result["launches"].update(fleet.pop("launches"))
    result["fleet"] = fleet
    if (out / "f32.pt").exists():
        f32 = torch.load(out / "f32.pt")
        for part in ("generate", "continuous"):
            smoke.check(torch.equal(f32[part], f32_one[part]),
                        f"serve mesh f32 {part} at full width over dp 2 x "
                        f"tp 2: tokens [8, 32] equal one process's")
    else:
        smoke.check(False, "serve mesh f32: rank 0 wrote its tokens")
    files = [out / f"f32-cache-rank{r}.json" for r in range(SERVE_MESH_RANKS)]
    caches = [json.loads(f.read_text()) for f in files if f.exists()]
    whole = f32_one["cache"]
    smoke.check(
        len(caches) == SERVE_MESH_RANKS
        and all((c["rows"], c["heads"])
                == (whole["rows"] // 2, whole["heads"] // 2)
                for c in caches),
        f"serve mesh f32 block-8 engine over dp 2 x tp 2: each rank's "
        f"cache (rows, heads) {[(c['rows'], c['heads']) for c in caches]} "
        f"of one process's ({whole['rows']}, {whole['heads']}); KV bytes "
        f"a rank {[c['bytes'] for c in caches]}, one process "
        f"{whole['bytes']}")
    result["f32_cache"] = {"ranks": caches, "one_process": whole}
    start = time.perf_counter()
    result["kernels"] = serve_mesh_kernels(torch, flash, smoke)
    print(f"-- serve mesh kernels: {time.perf_counter() - start:.3f} s",
          flush=True)
    return result


# the sims phase: the serving recipe's generations run on the card (the
# committed curve's first values), and the demos it runs as modules
SIMS_SERVING_GENS = 3
SIMS_DEMOS = ("kube_sqs_autoscaler_tpu_torch.sim.replay",
              "kube_sqs_autoscaler_tpu_torch.sim.faults",
              "kube_sqs_autoscaler_tpu_torch.core.durable",
              "kube_sqs_autoscaler_tpu_torch.learn")


def sync_guard(torch):
    """A context-manager factory for ``compiled.episode_guard``: any
    synchronizing call inside an episode batch's device loop raises."""
    import contextlib

    @contextlib.contextmanager
    def guard():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return guard


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler`` (device activity): ``(result,
    wall ms, kernel launches, kernel busy ms)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    kernels, _ = device_breakdown(prof)
    return (result, wall_ms, sum(count for _, count, _ in kernels),
            sum(ms for ms, _, _ in kernels))


def sims_part(torch, label: str, power: str, fn, unit, unit_label: str):
    """One part of the sims phase: ``fn()`` timed whole, then ``unit()``
    (one batch of its kind, cut to a tenth of its ticks or cycles: the
    profiler adds tens of microseconds a launch) profiled for its
    launches and the device's busy share, printed beside the card."""
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    _, unit_ms, launches, busy_ms = profiled(torch, unit)
    print(f"sims {label}: wall {wall_s:.3f} s; one {unit_label} (profiler "
          f"on): wall {unit_ms:.3f} ms, {launches} kernel launches, busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / unit_ms:.2f}%) [{power}]",
          flush=True)
    return result, {"wall_s": wall_s, "unit": unit_label,
                    "unit_ms": unit_ms, "unit_launches": launches,
                    "unit_busy_ms": busy_ms,
                    "unit_busy_share": busy_ms / unit_ms}


def sims_fluid(torch, smoke: Smoke, power: str) -> dict:
    """(a) and (b): the fluid twin's fidelity gate and the learn recipe."""
    from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import load_checkpoint
    from kube_sqs_autoscaler_tpu_torch.learn.rollout import (
        evaluate_population, learned_config,
    )
    from kube_sqs_autoscaler_tpu_torch.learn.train import ESConfig, train
    from kube_sqs_autoscaler_tpu_torch.sim import compiled
    from kube_sqs_autoscaler_tpu_torch.sim.evaluate import default_battery
    from kube_sqs_autoscaler_tpu_torch.sim.scenarios import scenario_variants

    learned_json = json.loads((ROOT / "LEARNED_POLICY.json").read_text())
    checkpoint = load_checkpoint(str(ROOT / "LEARNED_POLICY.json"))
    battery = list(default_battery())
    extra = [(f"{s.name}/learned", learned_config(s, checkpoint))
             for s in battery]
    # the profiled batch: the same episodes cut to 18 ticks
    short = [dataclasses.replace(s, duration=18 * s.loop.poll_interval)
             for s in battery]
    out = {}
    report, out["fidelity"] = sims_part(
        torch, "(a) fluid fidelity", power,
        lambda: compiled.verify_fidelity(battery, extra_episodes=extra),
        lambda: compiled.run_episodes_grouped(
            [c for _, c in compiled._fidelity_configs(
                short, ("ewma", "holt", "lstsq"))]),
        "compiled batch of 16 predictive and reactive episodes of 18 "
        "ticks")
    smoke.check(report.ok and report.episodes == 5 * len(battery),
                f"sims (a): verify_fidelity over {report.episodes} episodes "
                f"({report.ticks} ticks; reactive, ewma, holt, lstsq and "
                f"LEARNED_POLICY.json on {len(battery)} worlds), every batch "
                f"under set_sync_debug_mode('error'): "
                f"{len(report.divergences)} divergences "
                f"{report.format_divergences(3)} [{power}]")
    out["fidelity"]["divergences"] = len(report.divergences)
    worlds = battery + scenario_variants(battery, 2, seed=101)
    es = ESConfig(population=32, generations=40, seed=0, churn_weight=0.3,
                  replica_weight=0.15)
    thetas = np.zeros((33, 16 * 8 + 16 + 3 * 16 + 3), np.float32)
    result, out["recipe"] = sims_part(
        torch, "(b) fluid learn recipe", power, lambda: train(worlds, es),
        lambda: evaluate_population(thetas, worlds, hidden=16),
        f"generation ({33 * len(worlds)} episodes)")
    curve = [round(v, 6) for v in result.reward_curve]
    want = learned_json["meta"]["reward_curve"]
    smoke.check(curve == want and result.checkpoint.hash == "09f88697cfea"
                and result.checkpoint.theta.tolist() == learned_json["theta"],
                f"sims (b): the fluid learn recipe (population 32, 40 "
                f"generations, {len(worlds)} worlds) on the card: hash "
                f"{result.checkpoint.hash} (LEARNED_POLICY.json "
                f"09f88697cfea), curve {curve[:4]}... equal to the committed "
                f"one: {curve == want} [{power}]")
    out["recipe"]["hash"] = result.checkpoint.hash
    return out


def sims_twin(torch, flash, smoke: Smoke, power: str) -> dict:
    """(c) and (d): the serving twin against the real plane at the built-in
    GPT's width in bf16, and the serving recipe's first generations."""
    from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import load_checkpoint
    from kube_sqs_autoscaler_tpu_torch.learn.rollout import (
        evaluate_population_serving,
    )
    from kube_sqs_autoscaler_tpu_torch.learn.serving import (
        ServingESConfig, train_serving,
    )
    from kube_sqs_autoscaler_tpu_torch.sim.twin import (
        TwinConfig, default_twin_battery, run_twin_grouped, twin_variants,
        verify_twin_fidelity,
    )
    from kube_sqs_autoscaler_tpu_torch.sim.twin.host import HOST_PREFIX_LEN
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        builtin_config,
    )
    from kube_sqs_autoscaler_tpu_torch.workloads.model import init_params

    base = default_twin_battery(cycles=240)
    serving = load_checkpoint(str(ROOT / "SERVING_POLICY.json"))
    rows = [TwinConfig(scenario=s) for s in base] + [
        TwinConfig(scenario=s, policy="learned", checkpoint=serving)
        for s in base]
    # the built-in GPT (8 heads, D = 64, bf16): its inserts reach the
    # forward kernel.  The twin counts tokens and cycles, never their
    # content, which holds while no EOS reaches the plane: the host
    # episode's engine runs with eos_id=None.
    model_config = builtin_config(max(s.prompt_len for s in base),
                                  max(s.generate_tokens for s in base),
                                  prefix_len=HOST_PREFIX_LEN)
    params = init_params(model_config, torch.Generator().manual_seed(0),
                         "cuda")
    shapes: dict = {}
    launch = flash._launch

    def recording(name, dtype, device, *args):
        if name == "flash_fwd":
            b, h, hkv, sq, sk, d = args[5:11]
            shapes[(b, h, hkv, sq, sk, d)] = shapes.get(
                (b, h, hkv, sq, sk, d), 0) + 1
        return launch(name, dtype, device, *args)

    out = {}
    flash._launch = recording
    flash.kernel_launches = 0
    try:
        report, out["fidelity"] = sims_part(
            torch, "(c) twin fidelity", power,
            lambda: verify_twin_fidelity(rows, params=params,
                                         model_config=model_config),
            lambda: run_twin_grouped([TwinConfig(scenario=s) for s in
                                      default_twin_battery(cycles=24)]),
            f"compiled twin batch of {len(base)} reactive episodes of 24 "
            "cycles")
    finally:
        flash._launch = launch
    launched = flash.kernel_launches
    expected = model_config.n_layers * sum(
        e["insert_dispatches"] - e["pooled_inserts"] + e["prefix_installs"]
        for e in report.engines)
    inserts = sum(e["insert_dispatches"] for e in report.engines)
    smoke.check(report.ok and launched == expected > 0,
                f"sims (c): verify_twin_fidelity over {report.episodes} "
                f"episodes ({report.cycles} cycles) against the real plane "
                f"at d_model {model_config.d_model}, {model_config.n_heads} "
                f"heads, bf16: {len(report.divergences)} divergences "
                f"{report.format_divergences(3)}; flash_fwd launches "
                f"{launched} = {model_config.n_layers} layers x "
                f"{expected // model_config.n_layers} attention inserts "
                f"({inserts} insert dispatches, the pooled ones' suffix "
                f"forward launching none, plus the prefix installs) "
                f"[{power}]")
    out["fidelity"].update(divergences=len(report.divergences),
                           launches=launched, inserts=inserts,
                           shapes={"x".join(map(str, k)): v
                                   for k, v in shapes.items()})
    worlds = base + twin_variants(base, 1, seed=301)
    short = [dataclasses.replace(s, cycles=24) for s in worlds]
    thetas = np.zeros((25, 16 * 8 + 16 + 3 * 16 + 3), np.float32)
    result, out["recipe"] = sims_part(
        torch, f"(d) serving recipe, {SIMS_SERVING_GENS} generations",
        power, lambda: train_serving(worlds, ServingESConfig(
            population=24, generations=SIMS_SERVING_GENS)),
        lambda: evaluate_population_serving(thetas, short, hidden=16,
                                            history=16),
        f"generation ({25 * len(worlds)} episodes of 24 cycles)")
    want = json.loads((ROOT / "SERVING_POLICY.json").read_text())[
        "meta"]["reward_curve"][:SIMS_SERVING_GENS]
    curve = [round(v, 6) for v in result.reward_curve]
    smoke.check(curve == want,
                f"sims (d): the serving recipe's first {SIMS_SERVING_GENS} "
                f"generations on the card {curve}, SERVING_POLICY.json's "
                f"{want} [{power}]")
    out["recipe"]["curve"] = curve
    out["launches"] = launched
    out["shapes"] = shapes
    return out


def sims_demos(smoke: Smoke, power: str) -> dict:
    """(e): each demo as ``python -m``, on the card where it computes."""
    out = {}
    for module in SIMS_DEMOS:
        start = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", module],
                             capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        seconds = time.perf_counter() - start
        last = (run.stdout.strip().splitlines() or [""])[-1]
        smoke.check(run.returncode == 0 and '"ok": true' in last,
                    f"sims (e): python -m {module}: exit {run.returncode} "
                    f"in {seconds:.3f} s, {last[:160]} [{power}]"
                    + ("" if run.returncode == 0 else
                       f"\n{run.stderr[-1500:]}"))
        out[module] = {"rc": run.returncode, "wall_s": seconds}
    return out


def sims_kernels(torch, flash, smoke: Smoke, shapes: dict) -> dict:
    """The forward kernel at the twin's insert shapes (square causal ones,
    as the plane's inserts are), against its plain version in bf16, then
    timed beside its plain version, SDPA and its bound."""
    import torch.nn.functional as F

    timings, err = {}, 0.0
    for seed, (b, h, hkv, sq, sk, d) in enumerate(sorted(shapes)):
        if sq != sk:
            continue
        q, k, v = make_qkv(torch, b, h, hkv, sq, d, torch.bfloat16, True,
                           400 + seed)
        got = flash.flash_attention(q, k, v)
        want = flash.flash_attention_reference(q, k, v)
        e = (got.float() - want.float()).abs().max().item()
        smoke.check(bool(torch.isfinite(got).all().item())
                    and e <= TOL["bfloat16"],
                    f"flash_fwd twin insert B={b} H={h} H_kv={hkv} S={sq} "
                    f"D={d}: max|d|={e:.3e} tol={TOL['bfloat16']:g}")
        err = max(err, e)
        timing = gqa_timing(torch, flash, F, (b, h, hkv, sq, d), None)
        timing["launches"] = shapes[(b, h, hkv, sq, sk, d)]
        timings["x".join(map(str, (b, h, hkv, sq, d)))] = timing
    return {"timings": timings, "err": err}


def sims_phase(torch, flash, smoke: Smoke, power: str) -> dict:
    """The simulators, the serving twin and the trainers on the card (see
    the module doc, item 25)."""
    from kube_sqs_autoscaler_tpu_torch.sim import compiled

    compiled.episode_guard = sync_guard(torch)
    try:
        fluid = sims_fluid(torch, smoke, power)
        twin = sims_twin(torch, flash, smoke, power)
    finally:
        import contextlib

        compiled.episode_guard = contextlib.nullcontext
    demos = sims_demos(smoke, power)
    kernels = sims_kernels(torch, flash, smoke, twin["shapes"])
    return {"fluid": fluid, "twin": twin, "demos": demos,
            "kernels": kernels, "launches": {"sims-twin": twin["launches"]}}


# the cached decode attention (csrc/decode_attn.cu) at the benchmark
# cells' shapes, (B, H, H_kv, S, D, window), and at shapes that reach its
# other paths: both dtypes and head dims, query groups of 1, 2, 4, 8 and
# 16 (two blocks a kv head), a window, a split over chunks, and a cache
# whose batch dim is not contiguous (a view of a larger one)
DECODE_ATTN_CELLS = {
    "gpt2-xl.chat-backlog": (224, 25, 25, 1024, 64, None),
    "mistral-7b.rag-backlog": (80, 32, 8, 4109, 128, 4096),
}
DECODE_ATTN_CASES = [
    # (label, (B, H, H_kv, S, D, window), dtype name, strided)
    *((cell, shape, "bfloat16", False)
      for cell, shape in DECODE_ATTN_CELLS.items()),
    ("mha-f32-d64", (16, 8, 8, 544, 64, None), "float32", False),
    ("gqa-f32-d128-w128", (16, 32, 8, 1100, 128, 128), "float32", False),
    ("gqa-g2-d64-strided", (8, 8, 4, 700, 64, None), "bfloat16", True),
    ("gqa-g16-d128-w512", (4, 32, 2, 2000, 128, 512), "bfloat16", False),
    ("mqa-g8-f32-d64", (6, 8, 1, 3000, 64, None), "float32", True),
]
# the kernel is held, element by element, to the plain version run in f32
# on the same inputs upcast (fp32 probabilities, the kernel's arithmetic):
# one rounding of the output to its dtype (unit roundoff 2^-8 bf16, 2^-24
# f32) of |want|, plus 2^-12 of the largest |want| in its (row, head) for
# fp32 sums taken in another order (~1e-7 absolute; 2^-12 of a row's
# largest output is ~1.6e-5 at rag's lengths)
DECODE_ATTN_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -24}
DECODE_ATTN_SUM_ORDER = 2.0 ** -12


def decode_attn_limit(want, dtype_name: str):
    """Each output element's limit against the f32 plain version ``want``
    (``[B, H, 1, D]``): each row of each head held to its own scale."""
    size = want.abs()
    return (DECODE_ATTN_ROUNDOFF[dtype_name] * size
            + DECODE_ATTN_SUM_ORDER * size.amax(dim=-1, keepdim=True))


def decode_attn_check(torch, got, q, k, v, length, window,
                      dtype_name: str) -> dict:
    """``got`` (the kernel's output) against the plain version in f32 on
    the same inputs, ``k`` and ``v`` zero outside the valid keys: the
    largest |err| over its limit (must be at most 1), and the control: the
    plain answer over each row's keys moved back by one (its last valid
    key dropped; with a window, one more taken in at the front), rounded
    to the output dtype, against the same limits: the least over the rows
    whose keys it changes of the largest |err| over the limit (must pass
    1, so a kernel that lost a key at an edge would be refused)."""
    from kube_sqs_autoscaler_tpu_torch.workloads.decode import (
        _chunk_cached_attention,
    )

    s = k.shape[2]
    q32, k32, v32 = q.float(), k.float(), v.float()
    want = _chunk_cached_attention(q32, k32, v32, length, window)
    limit = decode_attn_limit(want, dtype_name)
    ratio = ((got.float() - want).abs() / limit).amax().item()
    moved = (length >= 1) & (length <= s - 1)
    off = _chunk_cached_attention(q32, k32, v32, (length - 1).clamp(min=0),
                                  window).to(got.dtype).float()
    per_row = ((off - want).abs() / limit).amax(dim=(1, 2, 3))
    control = per_row[moved].min().item()
    return {"err": (got.float() - want).abs().max().item(),
            "ratio": ratio, "control": control,
            "control_rows": int(moved.sum().item())}


def decode_attn_lengths(rng, batch: int, keys: int, window) -> np.ndarray:
    """Ragged lengths over every kind of row: a never-used slot (0), the
    cache's last position, an idle slot stepping on past the end, a freed
    slot holding its last length, one inside the first window, and the
    rest drawn over the whole cache."""
    special = [0, keys - 1, keys + 5, 37, min(keys - 1, (window or 64) - 1)]
    drawn = rng.integers(0, keys + 3, size=max(0, batch - len(special)))
    return np.array((special + drawn.tolist())[:batch], np.int64)


def decode_attn_inputs(torch, shape, dtype, strided, lengths, seed):
    """q, a cache filled everywhere, the same cache with NaN at every
    position outside each row's valid keys, and the lengths, on the card.
    ``strided`` takes q as a head view of a fused projection and the cache
    as every other row of one twice as large."""
    b, h, hkv, s, d, window = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        q = torch.randn((b, 1, 3 * h * d), generator=g, device="cuda",
                        dtype=dtype)[..., :h * d]
        q = q.view(b, 1, h, d).transpose(1, 2)
        k, v = (torch.randn((2 * b, hkv, s, d), generator=g, device="cuda",
                            dtype=dtype)[::2] for _ in range(2))
    else:
        q = torch.randn((b, h, 1, d), generator=g, device="cuda", dtype=dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda",
                            dtype=dtype) for _ in range(2))
    length = torch.from_numpy(lengths).cuda()
    hi = length.clamp(max=s - 1)
    lo = (hi - window + 1).clamp(min=0) if window else torch.zeros_like(hi)
    pos = torch.arange(s, device="cuda")
    outside = ((pos < lo[:, None]) | (pos > hi[:, None]))[:, None, :, None]
    k_nan, v_nan = (t.masked_fill(outside, float("nan")) for t in (k, v))
    return q, k, v, k_nan, v_nan, length


def decode_attn_bound_ms(shape, lengths, dtype_name) -> float:
    """The least time for the kernel's bytes: each row's valid keys of K
    and V read once, q read and the output written once, at 3.35 TB/s (the
    operations, 4 * D flops a valid (query head, key), take at most 2 * G
    flops a byte: never the bound)."""
    b, h, hkv, s, d, window = shape
    size = 2 if dtype_name == "bfloat16" else 4
    hi = np.minimum(lengths, s - 1)
    lo = np.maximum(0, hi - window + 1) if window else np.zeros_like(hi)
    moved = (int((hi - lo + 1).sum()) * hkv * d * 2 * size
             + 2 * b * h * d * size)
    return moved / PEAK_BYTES_PER_S * 1e3


def cell_lengths(rng, cell: str) -> np.ndarray:
    """The lengths a cell's slots hold mid-drain: its mix's prompts (the
    traffic file's log-normal, median and bounds) plus the tokens decoded
    so far."""
    mix = json.loads((Path(__file__).resolve().parent / "portbench"
                      / "traffic" / f"{cell.split('.', 1)[1]}.json")
                     .read_text())
    b = DECODE_ATTN_CELLS[cell][0]
    p = mix["prompt"]
    prompts = np.clip(np.exp(rng.normal(np.log(p["median"]), p["sigma"], b)),
                      p["min"], p["max"]).astype(np.int64)
    return prompts + rng.integers(0, mix["generate_tokens"], b)


def decode_attn_timing(torch, F, da, cell: str) -> dict:
    """The kernel at a cell's shape with the lengths its slots hold, timed
    beside its bytes bound, the plain version and one SDPA call over the
    whole cache with the valid keys as its mask (the yardstick; the port
    never calls it)."""
    b, h, hkv, s, d, window = shape = DECODE_ATTN_CELLS[cell]
    lengths = cell_lengths(np.random.default_rng(24), cell)
    q, k, v, _, _, length = decode_attn_inputs(
        torch, shape, torch.bfloat16, False, lengths, 2424)
    from kube_sqs_autoscaler_tpu_torch.workloads.decode import (
        _chunk_cached_attention,
    )

    kernel_ms = time_ms(torch, lambda: da.decode_attention(
        q, k, v, length, window), iters=50)
    plain_ms = time_ms(torch, lambda: _chunk_cached_attention(
        q, k, v, length, window), iters=10)
    hi = length.clamp(max=s - 1)
    lo = (hi - window + 1).clamp(min=0) if window else torch.zeros_like(hi)
    pos = torch.arange(s, device="cuda")
    mask = ((pos >= lo[:, None]) & (pos <= hi[:, None]))[:, None, None, :]
    extra = dict(enable_gqa=True) if hkv != h else {}
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, **extra), iters=10)
    bound_ms = decode_attn_bound_ms(shape, lengths, "bfloat16")
    whole_ms = decode_attn_bound_ms(
        shape, np.full(b, s - 1 if window is None else window - 1),
        "bfloat16")
    chunks, chunk_len = da.split(
        s, b * hkv, torch.cuda.get_device_properties(0).multi_processor_count)
    out = dict(shape=list(shape), mean_length=float(lengths.mean()),
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library_call="F.scaled_dot_product_attention forward with the "
                            "valid keys as a mask" +
                            (" (enable_gqa=True)" if extra else ""),
               bound_ms=bound_ms, bound_by="bytes",
               bound_share=bound_ms / kernel_ms,
               whole_cache_bound_ms=whole_ms, chunks=chunks,
               chunk_len=chunk_len)
    print(f"time decode_attn {cell} {shape} (mean length "
          f"{out['mean_length']:.1f}, {chunks} chunks of {chunk_len}): "
          f"kernel {kernel_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
          f"{100 * out['bound_share']:.1f}% of it), plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms; the whole cache's bytes "
          f"{whole_ms:.4f} ms", flush=True)
    return out


def decode_attn_drains(torch, da, smoke: Smoke) -> dict:
    """Each family's continuous drain at decode block 8 (the built-in
    models, 16 demo bodies) goes through the kernel once a layer a decode
    step."""
    from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousWorker,
    )

    out = {}
    for family in ("gpt", "llama"):
        config, params, service_config = demo_setup(
            torch, [*GENERATE_ARGS, "--family", family], 8)
        service_config.queue_url = "demo://queue"
        service_config.result_queue_url = ""
        queue = FakeMessageQueue()
        for body in demo_bodies(GATE_BODIES):
            queue.send_message(service_config.queue_url, body)
        worker = ContinuousWorker(queue, params, config, service_config,
                                  device="cuda")
        before = da.decode_attention_launches
        worker.drain(total=GATE_BODIES)
        torch.cuda.synchronize()
        steps = worker.batcher.decode_steps
        launches = da.decode_attention_launches - before
        smoke.check(worker.processed == GATE_BODIES and steps > 0
                    and launches == config.n_layers * steps,
                    f"decode attn {family} continuous drain: "
                    f"{worker.processed} of {GATE_BODIES} answered, "
                    f"decode_attention launches {launches} = "
                    f"{config.n_layers} layers x {steps} decode steps")
        out[family] = {"launches": launches, "decode_steps": steps}
    return out


class plain_decode_attention:
    """Within the block the cached decode attention takes its plain path
    on the card too (the routing predicate answers no)."""

    def __enter__(self):
        from kube_sqs_autoscaler_tpu_torch.workloads import decode_attn

        self.module = decode_attn
        self.kept = decode_attn.takes_kernel
        decode_attn.takes_kernel = lambda *args: False
        return self

    def __exit__(self, *exc):
        self.module.takes_kernel = self.kept


class f32_builtins:
    """Within the block the worker binary's built-in models are f32."""

    def __enter__(self):
        import torch
        from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
            BUILTIN_CONFIGS,
        )

        self.configs = BUILTIN_CONFIGS
        self.kept = dict(BUILTIN_CONFIGS)
        for family, build in self.kept.items():
            BUILTIN_CONFIGS[family] = partial(
                lambda build, *a: dataclasses.replace(
                    build(*a), dtype=torch.float32), build)
        return self

    def __exit__(self, *exc):
        self.configs.update(self.kept)


def decode_attn_modes(torch, flash, da, smoke: Smoke) -> dict:
    """Beam search, speculative decoding and the sharded plane through the
    worker binary (``--demo 16``), with the kernel and with the plain path
    on the same weights: in f32, where both compute the same function, the
    replies must be identical; in bf16 they are counted (the kernel keeps
    the probabilities fp32)."""
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        main as worker,
    )

    modes = {
        "beam": [*GENERATE_ARGS, *BEAM_ARGS],
        "speculative": [*GENERATE_ARGS, *SPEC_ARGS, "--continuous"],
        "sharded-plane": SHARDS_ARGS,
    }
    out = {}
    for dtype in ("float32", "bfloat16"):
        for mode, args in modes.items():
            runs = {}
            for path in ("plain", "kernel"):
                before = da.decode_attention_launches
                with contextlib.ExitStack() as stack:
                    if dtype == "float32":
                        stack.enter_context(f32_builtins())
                    if path == "plain":
                        stack.enter_context(plain_decode_attention())
                    summary, _, _, _ = run_binary(torch, flash, worker, args)
                check_served(smoke, f"decode attn {mode} {dtype} {path}",
                             summary)
                runs[path] = (replies_of(summary),
                              da.decode_attention_launches - before)
            same = count_same(runs["kernel"][0], runs["plain"][0])
            label = (f"decode attn {mode} {dtype}: replies through the "
                     f"kernel ({runs['kernel'][1]} launches) equal to the "
                     f"plain path's ({runs['plain'][1]} launches), "
                     f"{same} of {GATE_BODIES}")
            if dtype == "float32":
                smoke.check(same == GATE_BODIES and runs["kernel"][1] > 0
                            and runs["plain"][1] == 0, label)
            else:
                print(label + " (bf16, counted, not gated)", flush=True)
            out[f"{mode}-{dtype}"] = same
    return out


def decode_attn_phase(torch, flash, smoke: Smoke) -> dict:
    """The cached decode attention kernel (``csrc/decode_attn.cu``): its
    registers and spills; against its plain version in f32
    (:func:`decode_attn_check`) at the benchmark cells' shapes and at
    :data:`DECODE_ATTN_CASES`, over ragged lengths, with NaN at every cache
    position outside each row's valid keys (the kernel must never read
    one; the plain version gets zeros there, which its mask hides); timed
    at both cells' shapes; each family's drain through it once a layer a
    step; beam, speculative and sharded-plane replies against the plain
    path."""
    import torch.nn.functional as F

    from kube_sqs_autoscaler_tpu_torch.workloads import decode_attn as da

    out = {"resources": {}, "checks": {}, "timings": {}}
    for r in flash.kernel_resources("decode_attn"):
        out["resources"][f"{r['kernel']} {r['dtype']} {r['head_dim']}"] = r
        print(f"resources {r['kernel']} {r['dtype']} D={r['head_dim']}: "
              f"{r['registers']} registers, {r['local_bytes']} bytes local "
              f"(spills), {r['static_smem_bytes']} static bytes shared",
              flush=True)
    for key in ("decode_attn_g1 bf16 64", "decode_attn_g4 bf16 128"):
        r = out["resources"].get(key)
        smoke.check(r is not None and r["local_bytes"] == 0,
                    f"{key} (a cell's instantiation) uses no local memory: "
                    f"{None if r is None else r['local_bytes']} bytes")
    rng = np.random.default_rng(24)
    for label, shape, dtype_name, strided in DECODE_ATTN_CASES:
        dtype = getattr(torch, dtype_name)
        b, h, hkv, s, d, window = shape
        lengths = decode_attn_lengths(rng, b, s, window)
        q, k, v, k_nan, v_nan, length = decode_attn_inputs(
            torch, shape, dtype, strided, lengths, 2400 + b)
        before = da.decode_attention_launches
        got = da.decode_attention(q, k_nan, v_nan, length, window)
        torch.cuda.synchronize()
        launched = da.decode_attention_launches - before
        del k, v
        finite = bool(torch.isfinite(got).all())
        check = decode_attn_check(
            torch, got, q, torch.nan_to_num(k_nan, nan=0.0),
            torch.nan_to_num(v_nan, nan=0.0), length, window, dtype_name)
        smoke.check(
            finite and check["ratio"] <= 1 and check["control"] > 1
            and launched == 1,
            f"decode_attn {label} {dtype_name} {shape}: against the plain "
            f"version in f32, max |err| {check['err']:.3e}, at most "
            f"{check['ratio']:.3f} of its limit (one output rounding of "
            f"|want| + 2^-12 of its row's largest); the control (one key "
            f"off) at least {check['control']:.2f} of it over "
            f"{check['control_rows']} rows; finite with NaN outside the "
            f"valid keys ({finite}), {launched} launch")
        out["checks"][label] = check
        del q, k_nan, v_nan, got
    for cell in DECODE_ATTN_CELLS:
        out["timings"][cell] = decode_attn_timing(torch, F, da, cell)
    out["drains"] = decode_attn_drains(torch, da, smoke)
    out["modes"] = decode_attn_modes(torch, flash, da, smoke)
    return out


def decode_attn_main() -> int:
    """``--decode-attn``: the device, the build and the decode attention
    phase alone; exits 1 on any failure."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from kube_sqs_autoscaler_tpu_torch.workloads import flash, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    smoke.phase("device", device_phase, torch)
    smoke.phase("build", build_phase, kernels)
    result = smoke.phase("decode attn", decode_attn_phase, torch, flash,
                         smoke)
    if smoke.failures or result is None:
        print(json.dumps({"ok": False, "failures": smoke.failures}),
              flush=True)
        return 1
    print(json.dumps({"decode_attn": {
        "checks": result["checks"], "timings": result["timings"],
        "drains": result["drains"], "modes": result["modes"],
        "resources": {k: {f: r[f] for f in ("registers", "local_bytes",
                                            "static_smem_bytes")}
                      for k, r in result["resources"].items()},
    }}), flush=True)
    print(json.dumps({"ok": True}), flush=True)
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


def decode_attn_entry(result: dict, by_path: dict) -> dict:
    """The kernels line's entry of the cached decode attention kernel: it
    replaces no TPU kernel (the JAX package's is plain ``jnp``); timed at
    rag's shape, with chat's beside it."""
    rag, chat = (result["timings"][cell] for cell in (
        "mistral-7b.rag-backlog", "gpt2-xl.chat-backlog"))
    checks = result["checks"]
    used = {key: result["resources"][key] for key in (
        "decode_attn_g1 bf16 64", "decode_attn_g4 bf16 128")}
    return {
        "name": "decode_attn",
        "route": "cuda",
        "source": "kube_sqs_autoscaler_tpu_torch/csrc/decode_attn.cu",
        "replaces": None,
        "replaces_fn": "none: kube_sqs_autoscaler_tpu/workloads/decode.py "
                       "_cached_attention is plain jnp",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(c["err"] for c in checks.values()),
        "max_err_over_limit": max(c["ratio"] for c in checks.values()),
        "control_over_limit": min(c["control"] for c in checks.values()),
        "tol": "one output rounding of |want| + 2^-12 of its row's largest, "
               "against the plain version in f32",
        "shape": rag["shape"],
        "ms": rag["kernel_ms"],
        "kernel_ms": rag["kernel_ms"],
        "plain_ms": rag["plain_ms"],
        "library_ms": rag["library_ms"],
        "library_call": rag["library_call"],
        "bound_ms": rag["bound_ms"],
        "bound_by": rag["bound_by"],
        "at_other_shapes": {"x".join(map(str, chat["shape"][:5])): chat},
        "registers": {k: r["registers"] for k, r in used.items()},
        "spill_bytes": {k: r["local_bytes"] for k, r in used.items()},
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
    dattn = smoke.phase("decode attn", decode_attn_phase, torch, flash,
                        smoke)
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
    ctrl = smoke.phase("controller", controller_phase, torch, flash, smoke,
                       kern)
    policies = smoke.phase("policies", policy_phase, torch, smoke, power)
    shards = serve and stagger and smoke.phase(
        "shards", shards_phase, torch, flash, smoke, serve, stagger, fleet)
    llama = smoke.phase("llama", llama_phase, torch, flash, smoke)
    int8 = smoke.phase("int8", int8_phase, torch, flash, smoke)
    prefix = smoke.phase("prefix", prefix_phase, torch, flash, smoke)
    spec = smoke.phase("speculative", speculative_phase, torch, flash, smoke)
    beams = smoke.phase("beam", beam_phase, torch, flash, smoke)
    slice_prof = smoke.phase("beam profile", beam_profile, torch)
    spec and beams and smoke.phase("slice rates", slice_rates, spec, beams)
    sync = smoke.phase("sync", sync_phase, torch, smoke)
    gelu = smoke.phase("gelu cost", gelu_cost_phase, torch)
    tenancy = smoke.phase("tenancy", tenancy_phase, torch, flash, smoke)
    planes = smoke.phase("planes", planes_phase, torch, flash, smoke, power)
    orch = smoke.phase("orchestration", orchestration_phase, torch, flash,
                       smoke, power)
    odd = smoke.phase("odd head dim", odd_head_dim_phase, torch, flash, smoke)
    f32_train = smoke.phase("f32 train step", f32_train_phase, torch, flash,
                            smoke)
    train_path = smoke.phase("train path", train_path_phase, torch, flash,
                             smoke, power)
    train_prof = smoke.phase("train profile", train_profile_phase, torch)
    training = smoke.phase("training", training_phase, torch, flash, smoke,
                           power)
    launches = RankLaunches()
    for name, ranks, out, flag, timeout in (
            ("mesh", MESH_RANKS, MESH_DIR, "--mesh-rank", MESH_TIMEOUT),
            ("pipe", PIPE_RANKS, PIPE_DIR, "--pipe-rank", PIPE_TIMEOUT),
            ("serve mesh", SERVE_MESH_RANKS, SERVE_MESH_DIR,
             "--serve-mesh-rank", SERVE_MESH_TIMEOUT)):
        launches.add(name, ranks, out / "ranks", flag, timeout,
                     out / "ranks.log")
    # the sims phase runs in this process beside the rank launches (see
    # RankLaunches); on its own if the mesh phase never started them
    beside: dict = {}
    launches.beside.append(lambda: beside.update(sims=smoke.phase(
        "sims", sims_phase, torch, flash, smoke, power)))
    mesh = smoke.phase("mesh", mesh_phase, torch, flash, smoke, power,
                       launches)
    pipe = smoke.phase("pipe", pipe_phase, torch, flash, smoke, power,
                       launches)
    serve_mesh = smoke.phase("serve mesh", serve_mesh_phase, torch, flash,
                             smoke, power, launches)
    launches.run_beside()
    sims = beside.get("sims")
    # every serving path decodes through the cached decode attention
    # kernel: its launches in this process by phase, and by run of the
    # serving mesh's ranks (the worker binaries run as processes of their
    # own are not counted)
    decode_by_path = {**{f"phase-{name}": n for name, n in
                         smoke.decode_launches.items()},
                      **(serve_mesh or {}).get("decode_launches", {})}
    print(f"decode_attn launches by path: {decode_by_path}", flush=True)
    smoke.check(
        sum(n for name, n in decode_by_path.items()
            if name != "phase-decode attn") > 0,
        f"the serving paths outside the decode attn phase launched the "
        f"decode attention kernel: {decode_by_path}")
    if smoke.failures or not (info and sass and resources and kern
                              and train_kern and dattn and path and serve
                              and cycles
                              and stagger and rates and prof
                              and serve_prof and sqs and fleet and ctrl
                              and policies and shards
                              and llama and int8 and prefix and spec
                              and beams and slice_prof and sync and gelu
                              and tenancy and planes and orch and odd
                              and f32_train
                              and train_path and train_prof and training
                              and mesh and pipe and serve_mesh and sims):
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
        # the controller binary scaling an ElasticWorkerPool of batch
        # workers, reactive, then predictive and learned side by side
        "serve-controller": ctrl["launches"],
        "serve-controller-policies": ctrl["policies"]["launches"],
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
        # tenancy: the pool's install prefills (n_layers each; hits and
        # suffix inserts launch none), and the same streams with tenancy
        # off, prefix prepended (one prompt pass of 1024 an insert)
        **tenancy["launches"],
        # the serving planes: tenancy on the plane (the pool's installs),
        # admission shards, the decode plane's target inserts and draft
        # prefills, the prefill plane's inserts (the KV handoff launches
        # none)
        **planes["launches"],
        # the orchestration: traced and comms-on disaggregated episodes,
        # the evacuation's refills and resume inserts, the scheduled fleet
        # and the --scheduler binary (tracing and comms add none)
        **orch["launches"],
        **{f"train-{r}": v["launches"]["flash_fwd"]
           for r, v in train_path.items()},
        # the rest of training: the no-lse forward runs in eval passes
        # only, which these runs have none of
        **{path: v["flash_fwd"] for path, v in training["launches"].items()
           if v},
        # serving over a (data, model) mesh: each worker run over the ranks
        # (summed over its ranks)
        **serve_mesh["launches"],
        # the serving twin's host episodes: the real plane's inserts at the
        # built-in GPT's width
        **sims["launches"],
    }
    fwd = kernel_entry(
        "flash_fwd", "flash_fwd.cu", 159, "_fwd_kernel (need_lse=False)",
        sum(by_path.values()), by_path,
        max(kern["main_err"], kern["llama_err"],
            serve_mesh["kernels"]["err"]), timing, MAIN_SHAPES[0])
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
    # the ranks' shapes of the serving mesh, (B, H, H_kv, S, D), one
    # process alone on the card
    fwd["at_serve_mesh_shapes"] = {
        f"{label}-" + "x".join(map(str, (b, h, hkv, s, 64))): t
        for (label, b, h, hkv, s), t in zip(
            SERVE_MESH_SHAPES, serve_mesh["kernels"]["timings"].values())}
    # the serving twin's insert shapes (B, H, H_kv, S, D), with their
    # launches in the twin's host episodes
    fwd["at_twin_insert_shapes"] = sims["kernels"]["timings"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], sims["kernels"]["err"])
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
            {**{f"train-{r}": v["launches"][name]
                for r, v in train_path.items()},
             # the rest of training: the llama cell (causal, windowed),
             # checkpoint and resume, MoE, LoRA, corpus, profile, metrics
             **{path: v[name] for path, v in training["launches"].items()
                if v},
             # the mesh: ring and zig-zag hops, and the trainer over
             # ranks (each summed over its ranks)
             **{path: v[name] for path, v in mesh["launches"].items()},
             # the pipeline: each trainer run over the ranks, GPipe and
             # 1F1B (summed over its ranks)
             **{path: v[name] for path, v in pipe["launches"].items()}},
            train_kern["errs"][name], train_kern["timings"][name],
            TRAIN_SHAPE)
        entry["tflops"] = train_kern["timings"][name]["tflops"]
        # the ring and zig-zag hop shapes, one process alone on the card
        entry["at_mesh_hop_shapes"] = mesh["hop timing"][name]
        # the pipeline's per-microbatch stage shapes, alone on the card
        entry["at_pipe_stage_shapes"] = pipe["stage timing"][name]
        # the flagship llama train shape (B, H, H_kv, S, D), causal and
        # with the window
        entry["at_llama_train_shapes"] = {
            "x".join(map(str, LLAMA_TRAIN_SHAPE)) + (
                "" if label == "causal" else f"-w{LLAMA_TRAIN_WINDOW}"):
            timings[name]
            for label, timings in train_kern["llama_timings"].items()}
        entries.append(entry)
    for entry in entries:
        # the instantiation the main paths run: bf16, D = 64
        kernel = entry["name"].removesuffix("_lse")
        used = resources[(kernel, "bf16", TRAIN_SHAPE[3])]
        entry["registers"] = used["registers"]
        entry["spill_bytes"] = used["local_bytes"]
        entry["hmma_instructions"] = sass[f"{kernel} bf16 {TRAIN_SHAPE[3]}"]
    entries.append(decode_attn_entry(dattn, decode_by_path))
    print(f"-- total: {time.perf_counter() - smoke.start:.3f} s",
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"],
    }}), flush=True)
    return 0


def run() -> int:
    """:func:`main`, with every process it started stopped when it ends:
    normally, on an exception, or on SIGTERM, SIGINT or SIGHUP."""
    import signal

    mark = f"{os.getpid()}-{time.time_ns()}"
    os.environ[RUN_MARK] = mark
    os.environ[OWNER_PID] = str(os.getpid())

    def on_signal(signum, frame):
        stop_marked(RUN_MARK, mark)
        os._exit(128 + signum)

    for signum in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(signum, on_signal)
    try:
        return main()
    finally:
        left = stop_marked(RUN_MARK, mark)
        if left:
            print(f"chip_smoke: stopped {left} process(es) left running",
                  file=sys.stderr, flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--repair-cost":
        sys.exit(repair_cost_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--pipe-rank":
        sys.exit(pipe_rank_main(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-mesh-rank":
        sys.exit(serve_mesh_rank_main(sys.argv[2:]))
    if len(sys.argv) == 2 and sys.argv[1] == "--decode-attn":
        sys.exit(decode_attn_main())
    sys.exit(run())
