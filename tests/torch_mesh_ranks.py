"""Rank programs of the port's mesh tests, run as separate processes.

``run_ranks(case, world, payload)`` runs ``CASES[case](payload)`` on
``world`` gloo ranks on the CPU and returns every rank's result.  The
ranks are processes of this file, started as ``torch.distributed.run``
would start them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT`` on a free local port), once per rank count
in a test process: they join the process group once and then serve every
case of that count that any test file asks for, so a file's cases cost no
start-up of their own.  Each case has its own timeout: a hung or failed
rank fails the test with the ranks' output and ends that pool (the next
case starts a new one), never stalls the suite.  This module imports
torch and the port only, never JAX.
"""

from __future__ import annotations

import atexit
import os
import select
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


class _Pool:
    """``world`` rank processes serving cases one at a time: a case is a
    line ``<case> <dir>`` on every rank's stdin, answered by a line
    ``ok`` or ``error`` once the rank has written ``<dir>/rank<r>.pt``."""

    def __init__(self, world: int):
        self.world = world
        self.tmp = Path(tempfile.mkdtemp(prefix=f"mesh{world}-"))
        self.jobs = 0
        port = free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ)
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
            with open(self.tmp / f"rank{rank}.log", "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__))],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=log, env=env, cwd=str(ROOT)))

    def logs(self) -> str:
        return "\n----\n".join(
            (self.tmp / f"rank{r}.log").read_text(errors="replace")[-4000:]
            for r in range(self.world))

    def run(self, case: str, payload: dict, timeout: float) -> list:
        job = self.tmp / f"job{self.jobs}"
        self.jobs += 1
        job.mkdir()
        torch.save(payload, job / "in.pt")
        for proc in self.procs:
            proc.stdin.write(f"{case} {job}\n".encode())
            proc.stdin.flush()
        deadline = time.monotonic() + timeout
        answers = []
        for proc in self.procs:
            ready, _, _ = select.select(
                [proc.stdout], [], [], max(0.0, deadline - time.monotonic()))
            line = proc.stdout.readline().strip() if ready else b"timeout"
            answers.append(line or b"exited")
        if any(a != b"ok" for a in answers):
            raise RuntimeError(
                f"{case} over {self.world} ranks failed "
                f"({[a.decode() for a in answers]}, timeout {timeout} s):\n"
                + self.logs())
        results = [torch.load(job / f"rank{r}.pt", weights_only=False)
                   for r in range(self.world)]
        shutil.rmtree(job, ignore_errors=True)
        return results

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdin.close()
            proc.stdout.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


_pools: dict[int, _Pool] = {}


@atexit.register
def _close_pools() -> None:
    for pool in _pools.values():
        pool.close()
    _pools.clear()


def run_ranks(case: str, world: int, payload: dict,
              timeout: float = 120.0) -> list:
    """Every rank's result of ``case`` on ``payload``, in rank order."""
    pool = _pools.get(world)
    if pool is None:
        pool = _pools[world] = _Pool(world)
    try:
        return pool.run(case, payload, timeout)
    except RuntimeError as err:
        # a failed case may leave ranks inside a collective: end the pool
        del _pools[world]
        pool.close()
        raise AssertionError(str(err)) from None


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _mesh(tp: int, sp: int):
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    return distributed.make_mesh(model_parallel=tp, seq_parallel=sp,
                                 device="cpu")


def _local(t: torch.Tensor, mesh, heads: bool = True, seq_perm=None):
    """A rank's shard of a global ``[B, H, S, D]``: its data rows, its
    model heads and its seq positions (``seq_perm`` reorders them first,
    the zig-zag layout)."""
    data, seq, model = (mesh.axis(n) for n in ("data", "seq", "model"))
    b = t.shape[0] // data.size
    t = t[data.index * b:(data.index + 1) * b]
    if heads:
        h = t.shape[1] // model.size
        t = t[:, model.index * h:(model.index + 1) * h]
    if seq_perm is not None:
        t = t[:, :, seq_perm]
    s = t.shape[2] // seq.size
    return t[:, :, seq.index * s:(seq.index + 1) * s].contiguous()


def case_attention(payload):
    """Ring / zig-zag attention and its q, k, v gradients on every rank's
    shards, for each case of ``payload["cases"]``."""
    from kube_sqs_autoscaler_tpu_torch.workloads import ring, zigzag

    out = []
    meshes = {}
    for case in payload["cases"]:
        key = (case["tp"], case["sp"])
        if key not in meshes:
            meshes[key] = _mesh(*key)
        mesh = meshes[key]
        perm = None
        if case["kind"] == "zigzag":
            perm = torch.as_tensor(zigzag.zigzag_permutation(
                case["q"].shape[2], mesh.shape["seq"]))
            attend = zigzag.make_zigzag_ring_attention(mesh)
        else:
            attend = ring.make_ring_attention(mesh, window=case["window"])
        q, k, v, cot = (_local(case[n], mesh, seq_perm=perm).requires_grad_(
            n != "cot") for n in ("q", "k", "v", "cot"))
        o = attend(q, k, v)
        dq, dk, dv = torch.autograd.grad((o.float() * cot.float()).sum(),
                                         (q, k, v))
        out.append({"out": o.detach(), "dq": dq, "dk": dk, "dv": dv,
                    "coords": {n: mesh.axis(n).index
                               for n in ("data", "seq", "model")}})
    return {"results": out}


def case_train(payload):
    """Each run of ``payload["runs"]``: train steps on a mesh from full
    weights; every rank returns the losses, rank 0 also the gathered
    parameters."""
    from kube_sqs_autoscaler_tpu_torch.workloads import (
        llama, train, zigzag,
    )

    out = []
    for run in payload["runs"]:
        mesh = _mesh(run["tp"], run["sp"])
        config = run["config"]
        tcfg = train.TrainConfig(**run["train"])
        family = run["family"]
        if run.get("lora") is not None:
            out.append(_lora_run(run, mesh, config, tcfg))
            continue
        state = train.place_state(mesh, train.train_state(run["params"],
                                                          tcfg))
        if run.get("moe") is not None:
            from kube_sqs_autoscaler_tpu_torch.workloads import moe

            make = (moe.make_zigzag_moe_train_step if run.get("zigzag")
                    else moe.make_mesh_moe_train_step)
            step_fn = make(mesh, config, run["moe"], tcfg,
                           llama=family == "llama")
        elif run.get("zigzag"):
            forward = readout = None
            if family == "llama":
                forward, readout = (llama.llama_forward_hidden,
                                    llama.readout_weights)
            step_fn = zigzag.make_zigzag_train_step(
                mesh, config, tcfg, forward_fn=forward, readout_fn=readout)
        elif family == "llama":
            step_fn = llama.make_llama_train_step(config, tcfg, "cpu",
                                                  mesh=mesh)
        else:
            step_fn = train.make_train_step(config, tcfg, "cpu", mesh=mesh)
        data = mesh.axis("data")
        losses = []
        for batch in run["batches"]:
            rows = batch.shape[0] // data.size
            local = batch[data.index * rows:(data.index + 1) * rows]
            state, loss = step_fn(state, local)
            losses.append(float(loss))
        full = train.gather_state(mesh, state)
        out.append({"losses": losses, "step": state["step"],
                    "params": [t.detach() for t in train.param_leaves(
                        full["params"])] if mesh.rank == 0 else None})
    return out


def _lora_run(run, mesh, config, tcfg):
    """Adapter-only steps on a mesh: the frozen base sliced per rank, the
    adapters replicated; returns the losses and the adapters."""
    from kube_sqs_autoscaler_tpu_torch.workloads import llama, lora, train

    lcfg = lora.LoraConfig(rank=run["lora"])
    state = lora.init_lora_train_state(torch.Generator().manual_seed(1),
                                       run["params"], lcfg, tcfg)
    if run.get("adapters") is not None:
        with torch.no_grad():
            for live, given in zip(train.param_leaves(state["adapters"]),
                                   train.param_leaves(run["adapters"])):
                live.copy_(given)
    loss = (llama.llama_mesh_loss(config, tcfg, mesh)
            if run["family"] == "llama" else None)
    if run.get("zigzag"):
        from kube_sqs_autoscaler_tpu_torch.workloads import zigzag

        hidden = ((llama.llama_forward_hidden, llama.readout_weights)
                  if run["family"] == "llama" else (None, None))
        loss = zigzag.make_zigzag_loss(mesh, config, forward_fn=hidden[0],
                                       readout_fn=hidden[1])
    step_fn = lora.make_lora_train_step(
        config, tcfg, train.shard_params(run["params"], mesh), lcfg, "cpu",
        loss=loss, mesh=mesh)
    data = mesh.axis("data")
    losses = []
    for batch in run["batches"]:
        rows = batch.shape[0] // data.size
        state, loss_value = step_fn(
            state, batch[data.index * rows:(data.index + 1) * rows])
        losses.append(float(loss_value))
    return {"losses": losses, "step": state["step"],
            "params": [t.detach() for t in train.param_leaves(
                state["adapters"])]}


def case_trainer(payload):
    """The trainer binary on every rank; rank 0 returns its summary."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    import torch.distributed as dist

    try:
        out = trainer.main(payload["argv"])
    except SystemExit as err:
        return {"exit": err.code}
    lead = not dist.is_initialized() or dist.get_rank() == 0
    return {"losses": out["losses"], "final_step": out["final_step"],
            "params": out["params"] if lead else None}


def case_mesh(payload):
    """The mesh builders, the transport's collectives and
    ``prefetch_to_mesh`` on this rank."""
    import numpy as np

    from kube_sqs_autoscaler_tpu_torch.workloads import data, distributed

    out = {}
    mesh = distributed.make_topology_mesh(model_parallel=2, seq_parallel=2,
                                          device="cpu")
    out["shape"] = mesh.shape
    out["coords"] = {n: mesh.axis(n).index for n in distributed.AXES}
    out["groups"] = {n: mesh.axis(n).ranks for n in distributed.AXES}
    out["replicas"] = mesh.replicas.ranks
    auto = distributed.make_mesh(device="cpu")
    out["auto_shape"] = auto.shape
    for name, call in (
            ("topology_indivisible",
             lambda: distributed.make_topology_mesh(model_parallel=3,
                                                    device="cpu")),
            ("hybrid_multi_node",
             lambda: distributed.make_hybrid_mesh(2, model_parallel=2,
                                                  device="cpu"))):
        try:
            call()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    out["hybrid_one_node"] = distributed.make_hybrid_mesh(
        1, model_parallel=2, device="cpu").shape
    # one shift around the seq ring, forward and backward
    x = torch.full((3,), float(mesh.rank), requires_grad=True)
    (y,) = distributed.ring_shift(mesh, "seq", x)
    (y * (mesh.rank + 1)).sum().backward()
    out["shifted"] = y.detach()
    out["shift_grad"] = x.grad
    for depth in (0, 1, 2):
        source = [np.full((4, 8), i, dtype=np.int64) + np.arange(4)[:, None]
                  for i in range(5)]
        out[f"prefetch{depth}"] = [
            b.clone() for b in data.prefetch_to_mesh(iter(source), mesh,
                                                     depth=depth)]
    try:
        list(data.prefetch_to_mesh(iter([]), mesh, depth=-1))
        out["bad_depth"] = None
    except ValueError as err:
        out["bad_depth"] = str(err)
    return out


_PIPE_MESHES: dict = {}


def _pipe_mesh(pipe: int, tp: int, sp: int):
    """The pipeline mesh of that shape, built once per rank process (its
    groups are created collectively, in the order the cases ask)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import pipeline

    key = (pipe, tp, sp)
    if key not in _PIPE_MESHES:
        _PIPE_MESHES[key] = pipeline.make_pipeline_mesh(
            pipe, model_parallel=tp, seq_parallel=sp, device="cpu")
    return _PIPE_MESHES[key]


def case_pipeline(payload):
    """Each run of ``payload["runs"]`` on a pipeline mesh, from a full
    stage-stacked tree: ``"grads"`` returns the global loss and the
    summed gradients gathered to full tensors; ``"steps"`` runs optimizer
    steps and returns the losses and the gathered parameters; a run with
    ``lora`` trains adapters on the frozen base.  Rank 0 returns the
    tensors."""
    import numpy as np

    from kube_sqs_autoscaler_tpu_torch.workloads import (
        lora, pipeline, train,
    )

    out = []
    for run in payload["runs"]:
        mesh = _pipe_mesh(run["pipe"], run.get("tp", 1), run.get("sp", 1))
        config = run["config"]
        pcfg = pipeline.PipelineConfig(run["micro"], run["schedule"])
        tcfg = train.TrainConfig(**run.get("train", {}))
        options = dict(llama=run["family"] == "llama",
                       zigzag=run.get("zigzag", False), moe=run.get("moe"))
        lead = mesh.rank == 0

        def rows(batch):
            return torch.from_numpy(np.ascontiguousarray(
                pipeline.pipeline_rows(np.asarray(batch), mesh,
                                       pcfg.n_microbatches)))

        if run.get("lora") is not None:
            out.append(_pipeline_lora_run(mesh, config, pcfg, tcfg, run,
                                          rows, options))
            continue
        state = pipeline.place_pipeline_state(
            mesh, train.train_state(run["params"], tcfg))
        if run["kind"] == "grads":
            vag = pipeline.pipeline_value_and_grad(config, pcfg, mesh,
                                                   **options)
            loss, grads = vag(state["params"], rows(run["batches"][0]))
            # this rank's own share of the (tied) embedding's gradient
            embed_part = grads["embed"].clone()
            leaves = [g.contiguous() for g in train.param_leaves(grads)]
            train.reduce_grads(leaves, mesh, pipeline.pipeline_grad_axes(
                state["params"], mesh))
            loss = mesh.transport.all_reduce(
                loss, mesh.group(*pipeline.LOSS_AXES).group)
            full = pipeline.gather_pipeline_params(
                train._unflatten(state["params"], leaves), mesh)
            evaluated = float(pipeline.pipeline_loss(
                state["params"], rows(run["batches"][0]), config, pcfg,
                mesh, **options, aux_weight=0.0 if run.get("moe") else None))
            out.append({"loss": float(loss), "eval": evaluated,
                        "grads": full if lead else None,
                        "embed_part": embed_part,
                        "pipe_index": mesh.axis("pipe").index})
            continue
        step_fn = pipeline.make_pipeline_train_step(mesh, config, pcfg, tcfg,
                                                    **options)
        losses = []
        for batch in run["batches"]:
            state, loss = step_fn(state, rows(batch))
            losses.append(float(loss))
        full = pipeline.gather_pipeline_state(mesh, state)
        out.append({"losses": losses, "step": state["step"],
                    "params": full["params"] if lead else None})
    return out


def _pipeline_lora_run(mesh, config, pcfg, tcfg, run, rows, options):
    """Adapter-only steps through the pipeline from the given adapters;
    rank 0 returns the losses, the first step's adapter gradients and the
    gathered adapters."""
    from kube_sqs_autoscaler_tpu_torch.workloads import (
        lora, pipeline, train,
    )

    lcfg = lora.LoraConfig(rank=run["lora"])
    frozen = pipeline.shard_pipeline_params(run["params"], mesh)
    state = {"adapters": run["adapters"],
             "optimizer": train.make_optimizer(tcfg, run["adapters"]),
             "step": 0}
    state = lora.place_pipeline_lora_state(mesh, state)
    moe = options.pop("moe")
    options.pop("zigzag")
    vag = lora.lora_pipeline_value_and_grad(mesh, config, pcfg, frozen,
                                            lcfg, moe=moe, **options)
    _, grads = vag(state["adapters"], rows(run["batches"][0]))
    leaves = [g.contiguous() for g in train.param_leaves(grads)]
    train.reduce_grads(leaves, mesh, lora.lora_pipeline_grad_axes(
        state["adapters"], mesh))
    grads = lora.gather_pipeline_lora_state(mesh, {
        "adapters": train._unflatten(state["adapters"], leaves),
        "optimizer": state["optimizer"], "step": 0})["adapters"]
    step_fn = lora.make_lora_pipeline_train_step(mesh, config, pcfg, tcfg,
                                                 frozen, lcfg, moe=moe,
                                                 **options)
    losses = []
    for batch in run["batches"]:
        state, loss = step_fn(state, rows(batch))
        losses.append(float(loss))
    full = lora.gather_pipeline_lora_state(mesh, state)
    lead = mesh.rank == 0
    return {"losses": losses, "grads": grads if lead else None,
            "adapters": full["adapters"] if lead else None}


def case_pipe_mesh(payload):
    """The pipeline meshes of ``payload["shapes"]`` (``(pipe, tp, sp)``)
    as this rank sees them, enumeration and node-major order, and the
    divisibility refusal."""
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    out = []
    for pipe, tp, sp in payload["shapes"]:
        for topo in (False, True):
            mesh = (distributed.make_topology_pipeline_mesh(
                pipe, model_parallel=tp, seq_parallel=sp, device="cpu")
                if topo else _pipe_mesh(pipe, tp, sp))
            out.append({"shape": mesh.shape, "topology": topo,
                        "coords": {n: a.index for n, a in mesh.axes.items()},
                        "groups": {"+".join(sorted(k)): (None if a is None
                                                         else a.ranks)
                                   for k, a in mesh.groups.items()}})
    try:
        distributed.make_topology_pipeline_mesh(3, device="cpu")
        refused = None
    except ValueError as err:
        refused = str(err)
    return {"meshes": out, "refused": refused}


def case_serve(payload):
    """The serving-mesh jobs of ``torch_serve_ranks.py``."""
    from tests.torch_serve_ranks import case_serve as serve

    return serve(payload)


CASES = {"attention": case_attention, "train": case_train,
         "trainer": case_trainer, "mesh": case_mesh,
         "pipeline": case_pipeline, "pipe_mesh": case_pipe_mesh,
         "serve": case_serve}


def main() -> None:
    """Serve cases from stdin until it closes.  The protocol has the
    process's stdout to itself: whatever a case prints goes to stderr."""
    answer = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    torch.set_num_threads(1)
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    distributed.initialize_from_env(device="cpu")
    import torch.distributed as dist

    for line in sys.stdin:
        case, job = line.split()
        job = Path(job)
        try:
            payload = torch.load(job / "in.pt", weights_only=False)
            result = CASES[case](payload)
            torch.save(result, job / f"rank{os.environ['RANK']}.pt")
            dist.barrier()
        except BaseException:
            traceback.print_exc()
            print("error", file=answer, flush=True)
            sys.exit(1)
        print("ok", file=answer, flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()


def assemble(results: list[dict], index: int, key: str,
             shape) -> torch.Tensor:
    """The global ``[B, H, S, D]`` tensor of an attention case from every
    rank's shard of it (in the ranks' sequence order: natural for ring
    attention, zig-zag for zig-zag)."""
    first = results[0]["results"][index][key]
    out = torch.zeros(shape, dtype=first.dtype)
    for r in results:
        shard = r["results"][index][key]
        c = r["results"][index]["coords"]
        b, h, s = shard.shape[:3]
        out[c["data"] * b:(c["data"] + 1) * b,
            c["model"] * h:(c["model"] + 1) * h,
            c["seq"] * s:(c["seq"] + 1) * s] = shard
    return out


class AttentionSpawns:
    """The port's side of attention cases ``{name: (world, case)}``: one
    spawn per rank count, holding every case of that count, run when a
    case of it is first asked for."""

    def __init__(self, cases: dict):
        self.cases = cases
        self.done: dict[int, tuple[list, list[str]]] = {}

    def result(self, name: str) -> dict:
        """Case ``name``'s global output and q, k, v gradients (numpy
        fp32, in the ranks' sequence order)."""
        world, case = self.cases[name]
        if world not in self.done:
            names = [n for n, (w, _) in self.cases.items() if w == world]
            results = run_ranks("attention", world,
                                {"cases": [self.cases[n][1] for n in names]},
                                timeout=240)
            self.done[world] = (results, names)
        results, names = self.done[world]
        index = names.index(name)
        return {key: assemble(results, index, key,
                              case[src].shape).float().numpy()
                for key, src in (("out", "q"), ("dq", "q"), ("dk", "k"),
                                 ("dv", "v"))}
