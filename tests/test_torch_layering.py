"""The port stands alone: no ``jax`` and nothing of the JAX package.

An AST scan of every module of ``kube_sqs_autoscaler_tpu_torch`` (its
``core``, ``fleet``, ``metrics``, ``obs``, ``sim``, ``utils`` and
``workloads`` subpackages) and of ``chip_smoke.py`` finds no such import,
and a subprocess in which ``jax``, ``jaxlib`` and
``kube_sqs_autoscaler_tpu`` cannot be imported still imports the port and
runs a tiny forward, generate, worker cycle, continuous-worker drain,
fleet episode with its control loop, sharded-plane drain, sharded-pool
episode with a poisoned shard, llama forward, generate and two-shard
drain, int8 weights, int8 KV cache, chunk decode and shared-prefix serving
of both families, speculative and beam generation and their slot engines,
and train step on the CPU.  The
control-plane subpackages import no torch at all, so importing the fleet
starts no CUDA work and builds no kernel.
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


SUBPACKAGES = ("core", "fleet", "metrics", "obs", "sim", "utils",
               "workloads")


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert {path.parent.name for path in files} >= set(SUBPACKAGES)
    assert len(files) > 10
    assert PORT / "workloads" / "llama.py" in files
    assert PORT / "workloads" / "quantize.py" in files
    assert PORT / "workloads" / "speculative.py" in files
    assert PORT / "workloads" / "beam.py" in files
    offenders = {
        str(path.relative_to(ROOT)): name
        for path in files for name in absolute_imports(path) if banned(name)
    }
    assert offenders == {}


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
state = train.train_state(params, train.TrainConfig())
step = train.make_train_step(cfg, train.TrainConfig(), "cpu")
assert step(state, ids)[0]["step"] == 1
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
        "from kube_sqs_autoscaler_tpu_torch import core, fleet, obs, sim\n"
        "from kube_sqs_autoscaler_tpu_torch import metrics\n"
        "from kube_sqs_autoscaler_tpu_torch.fleet import __main__, sharded\n"
        "from kube_sqs_autoscaler_tpu_torch.utils import profiling, sigv4\n"
        "print(sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
