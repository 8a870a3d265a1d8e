"""The port stands alone: no ``jax`` and nothing of the JAX package.

An AST scan of every module of ``kube_sqs_autoscaler_tpu_torch`` (its
``comms``, ``core``, ``fleet``, ``forecast``, ``learn``, ``metrics``,
``native``, ``obs``
(``obs/lifecycle.py`` included), ``planes``, ``scale``, ``sched``, ``sim``, ``utils`` and
``workloads`` subpackages, ``cli.py`` and ``__main__.py``) and
of
``chip_smoke.py`` finds no such import,
and a subprocess in which ``jax``, ``jaxlib`` and
``kube_sqs_autoscaler_tpu`` cannot be imported still imports the port and
runs a tiny forward, generate, worker cycle, continuous-worker drain,
fleet episode with its control loop, sharded-plane drain, sharded-pool
episode with a poisoned shard, llama forward, generate and two-shard
drain, int8 weights, int8 KV cache, chunk decode and shared-prefix serving
of both families, speculative and beam generation and their slot engines,
a tenancy worker with its prefix pool, tenancy on a two-shard plane behind
the sharded admission plane, speculative rows on the decode plane, a
disaggregated prefill/decode pool with its KV handoff, traced and with a
routed collective scheduler attached, and train step on the CPU, then the
rest of training: a windowed llama step, a llama MoE step, a LoRA step, a
checkpoint saved and restored with its manifest, the HF state dicts and the
native corpus reader, a predictive and a learned control loop, and the
simulators, both compiled twins with their fidelity gates, both trainers,
a sweep and a journal replay
(``transformers`` never imported; a separate scan
finds it imported only inside the two HF directory functions and the
worker's tokenizer path).  The control-plane subpackages (and the ``planes`` package, whose
engines import lazily) import no torch at all, so importing the fleet
starts no CUDA work and builds no kernel; the controller binary runs a
``FakeClock`` episode with its resilience layer and durable state in a
subprocess where ``torch`` cannot be imported either.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kube_sqs_autoscaler_tpu_torch"
BANNED = ("jax", "jaxlib", "kube_sqs_autoscaler_tpu")


def banned(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in BANNED)


def absolute_imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


SUBPACKAGES = ("comms", "core", "fleet", "forecast", "learn", "metrics",
               "native", "obs", "planes", "scale", "sched", "sim", "utils",
               "workloads")


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert {path.parent.name for path in files} >= set(SUBPACKAGES)
    assert len(files) > 10
    assert PORT / "workloads" / "llama.py" in files
    assert PORT / "workloads" / "quantize.py" in files
    assert PORT / "workloads" / "speculative.py" in files
    assert PORT / "workloads" / "beam.py" in files
    assert PORT / "cli.py" in files and PORT / "__main__.py" in files
    assert PORT / "workloads" / "admission_shards.py" in files
    for name in ("engine.py", "prefill.py", "pool.py"):
        assert PORT / "planes" / name in files
    assert PORT / "obs" / "lifecycle.py" in files
    for name in ("ops.py", "topology.py", "routing.py", "scheduler.py"):
        assert PORT / "comms" / name in files
    for name in ("scheduler.py", "knobs.py", "fleet.py"):
        assert PORT / "sched" / name in files
    for name in ("checkpoint.py", "moe.py", "lora.py", "hf_convert.py",
                 "distributed.py", "ring.py", "zigzag.py"):
        assert PORT / "workloads" / name in files
    for name in ("__init__.py", "tokenreader.py"):
        assert PORT / "native" / name in files
    for name in ("forecasters.py", "history.py", "predictive.py",
                 "tenants.py"):
        assert PORT / "forecast" / name in files
    for name in ("network.py", "checkpoint.py", "policy.py", "rollout.py",
                 "train.py", "serving.py", "__main__.py"):
        assert PORT / "learn" / name in files
    for name in ("scenarios.py", "costmodel.py", "simulator.py",
                 "evaluate.py", "faults.py", "replay.py", "compiled.py",
                 "sweep.py"):
        assert PORT / "sim" / name in files
    for name in ("scenario.py", "compiled.py", "host.py", "fidelity.py",
                 "__init__.py"):
        assert PORT / "sim" / "twin" / name in files
    offenders = {
        str(path.relative_to(ROOT)): name
        for path in files for name in absolute_imports(path) if banned(name)
    }
    assert offenders == {}


def transformers_import_sites(path: Path) -> list[str]:
    """The enclosing function of every ``transformers`` import in a file
    (``<module>`` at the top level)."""
    sites = []

    def visit(node, where):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else where)
            names = []
            if isinstance(child, ast.Import):
                names = [alias.name for alias in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module]
            if any(n == "transformers" or n.startswith("transformers.")
                   for n in names):
                sites.append(where)
            visit(child, inner)

    visit(ast.parse(path.read_text(), str(path)), "<module>")
    return sites


def test_transformers_is_imported_only_where_a_directory_is_read():
    # the two HF directory functions and the worker's tokenizer path; the
    # state-dict conversions, the trainer and the rest never import it
    sites = {
        str(path.relative_to(ROOT)): sorted(transformers_import_sites(path))
        for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        if transformers_import_sites(path)
    }
    assert sites == {
        "kube_sqs_autoscaler_tpu_torch/workloads/hf_convert.py": [
            "load_hf_llama", "save_hf_llama"],
        "kube_sqs_autoscaler_tpu_torch/workloads/__main__.py": [
            "load_tokenizer"],
    }


def test_banned_check_is_exact():
    assert banned("jax.numpy") and banned("kube_sqs_autoscaler_tpu.workloads")
    assert not banned("kube_sqs_autoscaler_tpu_torch.workloads")
    assert not banned("jaxtyping")


CODE = """
import sys
for name in list(sys.modules):
    if name.split(".")[0] in {banned}:
        del sys.modules[name]
for name in {banned}:
    sys.modules[name] = None
try:
    import jax.numpy
except ImportError:
    pass
else:
    raise SystemExit("jax is still importable")

import json
import torch
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.workloads import decode, model, service
from kube_sqs_autoscaler_tpu_torch.workloads import __main__, worker  # noqa
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, shard_plane
from kube_sqs_autoscaler_tpu_torch.workloads import llama, quantize
from kube_sqs_autoscaler_tpu_torch.workloads import beam, speculative
from kube_sqs_autoscaler_tpu_torch.workloads import tenancy
from kube_sqs_autoscaler_tpu_torch.workloads import admission_shards  # noqa
from kube_sqs_autoscaler_tpu_torch import planes
from kube_sqs_autoscaler_tpu_torch.planes import engine, prefill  # noqa
from kube_sqs_autoscaler_tpu_torch.workloads import data, perf, train  # noqa
from kube_sqs_autoscaler_tpu_torch.workloads import trainer  # noqa
from kube_sqs_autoscaler_tpu_torch import core, fleet, metrics, obs, sim
from kube_sqs_autoscaler_tpu_torch.fleet import __main__ as fleet_main  # noqa
from kube_sqs_autoscaler_tpu_torch.metrics import sqs_aws  # noqa
from kube_sqs_autoscaler_tpu_torch.utils import profiling, sigv4  # noqa

cfg = model.ModelConfig(vocab_size=64, d_model=64, n_heads=1, n_layers=1,
                        d_ff=64, max_seq_len=32, dtype=torch.float32)
params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
ids = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(1))
assert model.forward(params, ids, cfg).shape == (2, 8, 64)
assert decode.generate(params, ids, 3, cfg).shape == (2, 3)
jobs = FakeMessageQueue()
jobs.send_message("q", json.dumps([1, 2, 3]))
w = service.QueueWorker(jobs, params, cfg,
                        service.ServiceConfig(queue_url="q", seq_len=8),
                        device="cpu")
assert w.run_once() == 1
jobs.send_message("q", json.dumps([1, 2, 3]))
cw = continuous.ContinuousWorker(
    jobs, params, cfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          decode_block=2),
    device="cpu")
assert cw.drain(total=1) == 1
for _ in range(3):
    jobs.send_message("q", json.dumps([1, 2, 3]))
pool = fleet.WorkerPool.serving(
    jobs, params, cfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          batch_size=1),
    min=1, max=2, clock=core.FakeClock(), device="cpu")
loop = core.ControlLoop(
    pool, metrics.QueueMetricSource(jobs, "q", ("ApproximateNumberOfMessages",)),
    core.LoopConfig(poll_interval=1.0, policy=core.PolicyConfig(
        scale_up_messages=2, scale_up_cooldown=0.0)),
    clock=pool.clock)
stats = fleet.FleetDriver(pool, loop, cycle_dt=0.5).run(until_processed=3)
assert stats["processed"] == 3 and max(stats["replica_trajectory"]) == 2
registry = obs.WorkloadMetrics()
pool.attach_metrics(registry)
assert "fleet_replica_state" in registry.render()
plane = shard_plane.ShardedBatcher(params, cfg, shards=2, shard_slots=1,
                                   prompt_len=8, generate_tokens=3,
                                   decode_block=2, device="cpu")
plane.submit_many([([1, 2, 3], "a"), ([4, 5], "b")])
while plane.active:
    plane.step()
assert plane.gang_cycles == plane.decode_dispatches > 0
for _ in range(3):
    jobs.send_message("q", json.dumps([1, 2, 3]))
sharded = fleet.ShardedWorkerPool.serving(
    jobs, params, cfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          batch_size=1, decode_block=2),
    min=1, max=2, shards=2, clock=core.FakeClock(), device="cpu")
stats = fleet.FleetDriver(
    sharded, fault_plan=sim.FleetFaultPlan(shard_poisons=((1, 3, 0),)),
    cycle_dt=0.5).run(until_processed=3)
assert stats["processed"] == 3 and sharded.quarantined_total == 1
lcfg = llama.LlamaConfig(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=1, d_ff=64, max_seq_len=32,
                         dtype=torch.float32)
lparams = llama.init_llama_params(lcfg, torch.Generator().manual_seed(0),
                                  "cpu")
assert llama.llama_forward(lparams, ids, lcfg).shape == (2, 8, 64)
assert llama.llama_generate(lparams, ids, 3, lcfg).shape == (2, 3)
jobs.send_message("q", json.dumps([1, 2, 3]))
lw = continuous.ContinuousWorker(
    jobs, lparams, lcfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          decode_block=2, shards=2),
    family="llama", device="cpu")
assert lw.drain(total=1) == 1 and lw.batcher.family == "llama"
# int8 weights, the int8 cache, the chunk decoders and the shared prefix
qparams = quantize.quantize_params(params, "gpt")
assert quantize.quantized_bytes(qparams) < quantize.quantized_bytes(params)
prefix = decode.quantized_prefill_prefix(qparams, [5, 6, 7], cfg)
assert decode.generate(qparams, ids, 3, cfg, quantized_cache=True,
                       prefix_cache=prefix).shape == (2, 3)
_, cache = decode.prefill(params, ids, cfg)
assert decode.chunk_decode(params, cache, ids[:, :2], cfg)[0].shape == (
    2, 2, 64)
_, qcache = decode.quantized_prefill(qparams, ids, cfg)
assert decode.quantized_chunk_decode(qparams, qcache, ids[:, :2],
                                     cfg)[0].shape == (2, 2, 64)
lq = quantize.quantize_params(lparams, "llama")
lprefix = llama.llama_quantized_prefill_prefix(lq, [5, 6], lcfg)
assert llama.llama_generate(lq, ids, 3, lcfg, quantized_cache=True,
                            prefix_cache=lprefix).shape == (2, 3)
_, lcache = llama.llama_prefill(lparams, ids, lcfg)
assert llama.llama_chunk_decode(lparams, lcache, ids[:, :2],
                                lcfg)[0].shape == (2, 2, 64)
for _ in range(2):
    jobs.send_message("q", json.dumps([1, 2, 3]))
qw = continuous.ContinuousWorker(
    jobs, lq, lcfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          decode_block=2, shards=2, quantized_kv=True),
    prefix_cache=lprefix, device="cpu")
assert qw.drain(total=2) == 2 and qw.batcher.prefix_len == 2
# speculative and beam generation, standalone and in the slot engines (a
# 2-layer llama, whose first layer is the self-draft)
l2cfg = llama.LlamaConfig(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
                          n_layers=2, d_ff=64, max_seq_len=32,
                          dtype=torch.float32)
l2params = llama.init_llama_params(l2cfg, torch.Generator().manual_seed(2),
                                   "cpu")
dparams, dcfg = speculative.self_draft(l2params, l2cfg, 1)
assert speculative.speculative_generate(
    l2params, l2cfg, dparams, dcfg, ids, 3, draft_tokens=2).shape == (2, 3)
assert beam.beam_search(params, cfg, ids, 3, beams=2).shape == (2, 3)
for knobs in (dict(draft_layers=1, draft_tokens=2), dict(beams=2)):
    sb = continuous.ContinuousBatcher(l2params, l2cfg, batch_size=2,
                                      prompt_len=4, generate_tokens=3,
                                      device="cpu", **knobs)
    sb.submit_many([([1, 2, 3], 0), ([4, 5], 1)])
    out = []
    while sb.active:
        out += sb.step()
    assert sorted(p for p, _ in out) == [0, 1]
# tenancy: a prefixed and a plain body through the pooled worker
for body in ({"tenant": "a", "prefix": [7, 8, 9, 10], "ids": [1, 2]},
             [3, 4, 5]):
    jobs.send_message("q", json.dumps(body))
tw = continuous.ContinuousWorker(
    jobs, params, cfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          batch_size=2, decode_block=2),
    tenancy=tenancy.TenancyConfig(tenants=("a", "b"), prefix_pool=2,
                                  prefix_len=4, shed_tiers=3),
    device="cpu")
assert tw.drain(total=2) == 2 and tw.batcher.prefix_pool.installs == 1
assert tw.completed_by_tenant == {"a": 2}
# tenancy on a two-shard plane behind four admission shards, with
# speculative rows on the decode plane
for body in ({"tenant": "a", "prefix": [7, 8, 9, 10], "ids": [1, 2]},
             {"tenant": "b", "ids": [3, 4, 5]}):
    jobs.send_message("q", json.dumps(body))
pw = continuous.ContinuousWorker(
    jobs, l2params, l2cfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          batch_size=1, decode_block=2, shards=2),
    tenancy=tenancy.TenancyConfig(tenants=("a", "b"), prefix_pool=1,
                                  prefix_len=4, admission_shards=4),
    draft_layers=1, draft_tokens=2, device="cpu")
assert pw.drain(total=2) == 2 and pw.completed_by_tenant == {"a": 1, "b": 1}
assert isinstance(pw.batcher, planes.DecodePlaneBatcher)
assert pw.batcher.spec_rounds > 0 and pw.batcher._tenant_home
# the disaggregated planes: prefill replicas hand their rows to the decode
# plane by a KV copy
for _ in range(3):
    jobs.send_message("q", json.dumps([1, 2, 3]))
disagg = planes.DisaggregatedPool.serving(
    jobs, l2params, l2cfg,
    service.ServiceConfig(queue_url="q", seq_len=8, generate_tokens=3,
                          batch_size=2, decode_block=2),
    min=1, max=1, decode_shards=2, spec_layers=1, spec_tokens=2,
    clock=core.FakeClock(), device="cpu")
from kube_sqs_autoscaler_tpu_torch import comms
registry = obs.LifecycleRegistry()
disagg.attach_lifecycle(registry)
disagg.attach_comms(comms.CollectiveScheduler(
    lifecycle=registry, topology=comms.topology_from_geometry("torus", shards=2)))
for _ in range(20):
    disagg.run_cycle()
assert disagg.processed == 3 and disagg.kv_handoffs_total == 3
assert registry.replies == 3
state = train.train_state(params, train.TrainConfig())
step = train.make_train_step(cfg, train.TrainConfig(), "cpu")
assert step(state, ids)[0]["step"] == 1
# the rest of training: a windowed llama step, MoE, LoRA, a checkpoint
# saved and restored, the HF state dicts and the native corpus reader
import tempfile
import numpy as np
from kube_sqs_autoscaler_tpu_torch.workloads import (
    checkpoint, data, hf_convert, lora, moe)
from kube_sqs_autoscaler_tpu_torch.native import tokenreader
wcfg = llama.LlamaConfig(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
                         n_layers=1, d_ff=64, max_seq_len=32,
                         sliding_window=4, dtype=torch.float32)
lstate = llama.init_llama_train_state(torch.Generator().manual_seed(3), wcfg,
                                      train.TrainConfig(), "cpu")
lstate, lloss = llama.make_llama_train_step(wcfg, train.TrainConfig(),
                                            "cpu")(lstate, ids)
mcfg = moe.MoeConfig(n_experts=2, top_k=1)
mstate = moe.init_llama_moe_train_state(torch.Generator().manual_seed(4),
                                        wcfg, mcfg, train.TrainConfig(),
                                        "cpu")
mstate, _ = moe.make_llama_moe_train_step(wcfg, mcfg, train.TrainConfig(),
                                          "cpu")(mstate, ids)
lcfg_ = lora.LoraConfig(rank=2)
astate = lora.init_lora_train_state(torch.Generator().manual_seed(5), params,
                                    lcfg_, train.TrainConfig())
astate, _ = lora.make_lora_train_step(cfg, train.TrainConfig(), params,
                                      lcfg_, "cpu")(astate, ids)
with tempfile.TemporaryDirectory() as tmp:
    saver = checkpoint.TrainCheckpointer(tmp + "/ck")
    saver.save(lstate)
    again = llama.init_llama_train_state(torch.Generator().manual_seed(9),
                                         wcfg, train.TrainConfig(), "cpu")
    assert saver.restore(again)["step"] == 1
    checkpoint.save_model_manifest(tmp + "/ck", "llama", wcfg)
    family, read = checkpoint.load_model_manifest(tmp + "/ck")
    assert family == "llama" and read.sliding_window == 4
    tokenreader.write_token_shards(tmp + "/corpus", np.arange(500) % 64, 64)
    batch = next(data.corpus_token_stream(tmp + "/corpus", 2, 8, seed=1))
    assert batch.shape == (2, 8)
# the training mesh: a one-rank process group over gloo, a mesh step
# through the ring's per-rank seam, and the zig-zag permutation
import socket
from kube_sqs_autoscaler_tpu_torch.workloads import distributed, ring, zigzag
sock = socket.socket(); sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]; sock.close()
assert distributed.initialize_from_env(
    device="cpu", init_method=f"tcp://127.0.0.1:{port}", rank=0,
    world_size=1)
mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1, device="cpu")
mstate_ = train.place_state(mesh, train.train_state(params,
                                                    train.TrainConfig()))
mstate_, _ = train.make_train_step(cfg, train.TrainConfig(), "cpu",
                                   mesh=mesh)(mstate_, ids)
assert mstate_["step"] == 1 and ring.make_ring_attention(mesh).gqa_native
assert len(zigzag.zigzag_permutation(8, 2)) == 8
back = hf_convert.llama_params_from_hf(
    hf_convert.hf_state_dict_from_llama(lparams, lcfg), lcfg, device="cpu")
assert all(torch.equal(a, b) for a, b in zip(train.param_leaves(back),
                                             train.param_leaves(lparams)))
# forecasting and the learned policy: a predictive and a learned tick of
# the real loop, the learned one on the reference's checkpoint file
from kube_sqs_autoscaler_tpu_torch import forecast, learn
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeQueueService
from kube_sqs_autoscaler_tpu_torch.scale import FakeDeploymentAPI, PodAutoScaler
checkpoint = learn.load_checkpoint("LEARNED_POLICY.json", device="cpu")
for depth_policy in (
        forecast.PredictivePolicy(forecast.make_forecaster("holt",
                                                           device="cpu")),
        learn.LearnedPolicy(checkpoint, policy=core.PolicyConfig(),
                            poll_interval=5.0, max_pods=3)):
    api = FakeDeploymentAPI.with_deployments("ns", 1, "d")
    loop = core.ControlLoop(
        PodAutoScaler(client=api, max=3, min=1, scale_up_pods=1,
                      scale_down_pods=1, deployment="d", namespace="ns"),
        metrics.QueueMetricSource(client=FakeQueueService.with_depths(500),
                                  queue_url="q"),
        core.LoopConfig(poll_interval=5.0), clock=core.FakeClock(),
        observer=getattr(depth_policy, "history", depth_policy),
        depth_policy=depth_policy)
    loop.run(max_ticks=4)
    assert depth_policy.last_prediction is not None
# the simulators, the twins and the trainers: a fluid fidelity pass with
# the learned policy, a serving-twin fidelity pass against the real
# plane, one ES generation in each twin, the demos' checks
from dataclasses import replace as dc_replace
from kube_sqs_autoscaler_tpu_torch.sim import compiled, evaluate, replay
from kube_sqs_autoscaler_tpu_torch.sim import sweep, twin
from kube_sqs_autoscaler_tpu_torch.learn import rollout, serving
from kube_sqs_autoscaler_tpu_torch.learn import train as es
short = [dc_replace(evaluate.default_battery()[1], duration=60.0)]
report = compiled.verify_fidelity(
    short, forecasters=("holt",), extra_episodes=[
        ("learned", rollout.learned_config(short[0], checkpoint))],
    device="cpu")
assert report.ok and report.episodes == 3
worlds = twin.default_twin_battery(cycles=12)[:2]
assert twin.verify_twin_fidelity(worlds, device="cpu").ok
assert len(es.train(short, es.ESConfig(population=2, generations=1),
                    device="cpu").reward_curve) == 1
assert len(serving.train_serving(worlds, serving.ServingESConfig(
    population=2, generations=1), device="cpu").reward_curve) == 1
assert sweep.run_sweep([sweep.SweepPoint()], short, device="cpu").points == 1
with tempfile.TemporaryDirectory() as tmp:
    replay.record_episode(compiled.SimConfig(duration=50.0), tmp + "/j")
    assert replay.replay_journal(tmp + "/j").ok
assert "transformers" not in sys.modules
assert not any(n.split(".")[0] in {banned} and sys.modules[n] is not None
               for n in sys.modules)
print("ok")
"""


def test_port_runs_with_jax_and_the_jax_package_unimportable():
    code = CODE.replace("{banned}", repr(set(BANNED)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_control_plane_imports_no_torch():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "from kube_sqs_autoscaler_tpu_torch import cli, core, fleet, obs, sim\n"
        "from kube_sqs_autoscaler_tpu_torch import scale\n"
        "from kube_sqs_autoscaler_tpu_torch.scale import kube\n"
        "from kube_sqs_autoscaler_tpu_torch.core import durable\n"
        "from kube_sqs_autoscaler_tpu_torch import metrics\n"
        "from kube_sqs_autoscaler_tpu_torch.fleet import __main__, sharded\n"
        "from kube_sqs_autoscaler_tpu_torch import planes\n"
        "from kube_sqs_autoscaler_tpu_torch.planes import pool\n"
        "from kube_sqs_autoscaler_tpu_torch import comms, sched\n"
        "from kube_sqs_autoscaler_tpu_torch.sched import fleet as sf, knobs\n"
        "from kube_sqs_autoscaler_tpu_torch.obs import lifecycle\n"
        "from kube_sqs_autoscaler_tpu_torch.utils import profiling, sigv4\n"
        "from kube_sqs_autoscaler_tpu_torch import native\n"
        "print(sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


CONTROLLER = """
import sys
for name in list(sys.modules):
    if name.split(".")[0] in {banned}:
        del sys.modules[name]
for name in {banned}:
    sys.modules[name] = None
import tempfile
import kube_sqs_autoscaler_tpu_torch.cli
from kube_sqs_autoscaler_tpu_torch.core import FakeClock, ControlLoop
from kube_sqs_autoscaler_tpu_torch.core import LoopConfig, PolicyConfig
from kube_sqs_autoscaler_tpu_torch.core import ResilienceConfig
from kube_sqs_autoscaler_tpu_torch.core.durable import DurableStateStore
from kube_sqs_autoscaler_tpu_torch.metrics import FakeQueueService
from kube_sqs_autoscaler_tpu_torch.metrics import QueueMetricSource
from kube_sqs_autoscaler_tpu_torch.obs import ControllerMetrics, TickJournal
from kube_sqs_autoscaler_tpu_torch.scale import FakeDeploymentAPI
from kube_sqs_autoscaler_tpu_torch.scale import PodAutoScaler
from kube_sqs_autoscaler_tpu_torch.sim import Blackout, FaultyScaler

with tempfile.TemporaryDirectory() as tmp:
    clock = FakeClock()
    api = FakeDeploymentAPI.with_deployments("ns", 1, "w")
    store = DurableStateStore(tmp + "/s.json", wall_clock=clock.now)
    loop = ControlLoop(
        FaultyScaler(PodAutoScaler(client=api, max=4, min=1, scale_up_pods=1,
                                   scale_down_pods=1, deployment="w",
                                   namespace="ns"),
                     Blackout(start=5.0, duration=6.0, metric=False,
                              scale=True), clock),
        QueueMetricSource(FakeQueueService.with_depths(500), "q",
                          ("ApproximateNumberOfMessages",)),
        LoopConfig(poll_interval=1.0, policy=PolicyConfig(
            scale_up_cooldown=2.0)),
        clock=clock, resilience=ResilienceConfig(
            scaler_retries=1, breaker_failures=2, breaker_reset=3.0),
        durable=store)
    store.register("resilience", loop.resilience)
    metrics = ControllerMetrics()
    journal = TickJournal(tmp + "/j.jsonl")
    from kube_sqs_autoscaler_tpu_torch.core.events import MultiObserver
    loop.observer = MultiObserver([metrics, journal])
    loop.run(max_ticks=20)
    journal.close()
    assert api.replicas("w") == 4 and store.snapshots_written == 20
    assert "kube_sqs_autoscaler_breaker_state 0" in metrics.render()
assert not any(n.split(".")[0] in {banned} and sys.modules[n] is not None
               for n in sys.modules)
print("ok")
"""


def test_controller_runs_with_torch_and_jax_unimportable():
    banned = set(BANNED) | {"torch", "numpy"}
    out = subprocess.run(
        [sys.executable, "-c", CONTROLLER.replace("{banned}", repr(banned))],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
