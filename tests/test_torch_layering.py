"""The port stands alone: no ``jax`` and nothing of the JAX package.

An AST scan of every module of ``kube_sqs_autoscaler_tpu_torch`` and of
``chip_smoke.py`` finds no such import, and a subprocess in which ``jax``,
``jaxlib`` and ``kube_sqs_autoscaler_tpu`` cannot be imported still
imports the port and runs a tiny forward, generate and worker cycle on
the CPU.
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


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
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
