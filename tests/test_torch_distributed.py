"""The port's process start-up, meshes, transport and input pipeline
(``workloads/distributed.py``, ``data.prefetch_to_mesh``) against the JAX
package's ``distributed.py`` and ``data.py``.

Multi-rank cases run as 2 or 4 gloo ranks in spawned processes
(``torch_mesh_ranks.py``); the reference's meshes run on its virtual
8-device CPU mesh.  The two-rank data path mirrors the reference's
two-process test: both ranks train on their halves of the batch and
report the same loss, equal (1e-5 relative) to the reference's step on a
2-device data mesh.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import data as jax_data
from kube_sqs_autoscaler_tpu.workloads import distributed as jax_dist
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import data, distributed
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from kube_sqs_autoscaler_tpu_torch.workloads.model import ModelConfig
from .torch_mesh_ranks import run_ranks

torch.set_num_threads(1)

_mesh_case = {}


def four_ranks():
    if not _mesh_case:
        _mesh_case["results"] = run_ranks("mesh", 4, {}, timeout=180)
    return _mesh_case["results"]


def test_initialize_from_env_is_noop_single_process(monkeypatch):
    for var in ("KSAT_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_backend_is_chosen_explicitly(monkeypatch):
    assert distributed.choose_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert distributed.choose_backend("cuda") == "nccl"
    # four ranks sharing one card: NCCL would refuse the duplicate GPU
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.choose_backend("cuda") == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cuda") == torch.device("cuda", 0)
    assert distributed.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("n, tp, sp", [(8, 3, 1), (8, 2, 3), (4, 1, 8)])
def test_mesh_shape_validates_as_the_reference(n, tp, sp):
    with pytest.raises(ValueError, match="divisible") as got:
        distributed.mesh_shape(n, tp, sp)
    with pytest.raises(ValueError) as want:
        jax_train.mesh_shape(n, tp, sp)
    assert str(got.value) == str(want.value)
    assert distributed.mesh_shape(8, 2, 2) == jax_train.mesh_shape(8, 2, 2)


def test_topology_mesh_over_four_ranks():
    results = four_ranks()
    ref = jax_dist.make_topology_mesh(model_parallel=2, seq_parallel=2,
                                      devices=jax.devices()[:4])
    for r in results:
        assert r["shape"] == dict(ref.shape)
    # the grid is row-major over (data, seq, model) in rank order
    by_rank = {r["coords"]["data"] * 4 + r["coords"]["seq"] * 2
               + r["coords"]["model"]: r for r in results}
    assert sorted(by_rank) == [0, 1, 2, 3]
    assert results[0]["groups"] == {"data": [0], "seq": [0, 2],
                                    "model": [0, 1]}
    assert results[3]["groups"] == {"data": [3], "seq": [1, 3],
                                    "model": [2, 3]}
    # gradients sum over the ranks holding the same model slice
    assert results[0]["replicas"] == [0, 2]
    assert results[1]["replicas"] == [1, 3]


def test_default_mesh_picks_the_references_model_axis():
    ref = jax_train.make_mesh(jax.devices()[:4])
    assert all(r["auto_shape"] == dict(ref.shape) for r in four_ranks())


def test_topology_mesh_validates_divisibility():
    with pytest.raises(ValueError) as want:
        jax_train.mesh_shape(4, 3, 1)
    assert all(r["topology_indivisible"] == str(want.value)
               for r in four_ranks())


def test_hybrid_mesh_single_node_degenerates_to_topology():
    ref = jax_dist.make_topology_mesh(model_parallel=2,
                                      devices=jax.devices()[:4])
    assert all(r["hybrid_one_node"] == dict(ref.shape)
               for r in four_ranks())


def test_hybrid_mesh_multi_node_requires_multiple_nodes():
    # every rank runs on this one host, so a 2-node data axis must fail
    # loudly rather than mis-assign
    assert all("spans 1" in r["hybrid_multi_node"] for r in four_ranks())


def test_ring_shift_rotates_forward_and_its_gradient_back():
    results = four_ranks()
    by_rank = {r["coords"]["data"] * 4 + r["coords"]["seq"] * 2
               + r["coords"]["model"]: r for r in results}
    for rank, r in by_rank.items():
        seq_ranks = r["groups"]["seq"]
        me = seq_ranks.index(rank)
        prev = seq_ranks[(me - 1) % len(seq_ranks)]
        nxt = seq_ranks[(me + 1) % len(seq_ranks)]
        # this rank received its previous rank's tensor ...
        assert torch.equal(r["shifted"], torch.full((3,), float(prev)))
        # ... and the gradient of what it sent came back from the next
        assert torch.equal(r["shift_grad"], torch.full((3,), nxt + 1.0))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_preserves_order_values_and_rows(depth):
    for r in four_ranks():
        batches = r[f"prefetch{depth}"]
        assert len(batches) == 5
        # a data axis of 1: every rank keeps the whole batch
        for i, batch in enumerate(batches):
            want = np.full((4, 8), i) + np.arange(4)[:, None]
            np.testing.assert_array_equal(batch.numpy(), want)


def test_prefetch_validates_depth():
    assert all("depth=-1 must be >= 0" in r["bad_depth"]
               for r in four_ranks())
    with pytest.raises(ValueError) as want:
        list(jax_data.prefetch_to_mesh(iter([]), None, depth=-1))
    assert str(want.value) in four_ranks()[0]["bad_depth"]


def test_prefetch_runs_ahead_of_consumption():
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield np.full((8, 8), i, dtype=np.int64)

    it = data.prefetch_to_mesh(source(), mesh, depth=2)
    first = next(it)
    assert len(pulled) >= 3
    np.testing.assert_array_equal(first.numpy(), 0)
    assert sum(1 for _ in it) == 5


def test_mesh_rows_split_the_batch_over_data():
    class Axis:
        size, index = 2, 1

    class Mesh:
        def axis(self, name):
            return Axis

    batch = np.arange(8)[:, None] * np.ones((1, 4), dtype=np.int64)
    np.testing.assert_array_equal(data.mesh_rows(batch, Mesh()), batch[4:])
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        data.mesh_rows(batch[:3], Mesh())


def test_two_rank_data_path_and_train_step():
    dims = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_seq_len=64)
    jcfg = jax_model.ModelConfig(**dims, dtype=jnp.float32)
    npp = jax.tree.map(np.asarray,
                       jax_model.init_params(jax.random.key(0), jcfg))
    batches = list(itertools.islice(
        jax_data.synthetic_token_stream(256, 4, 32, seed=3), 2))
    cfg = ModelConfig(**dims, dtype=torch.float32)
    results = run_ranks("train", 2, {"runs": [dict(
        family="gpt", config=cfg, tp=1, sp=1,
        train=dict(learning_rate=1e-2),
        params=params_from_jax(npp, cfg, "cpu"),
        batches=[torch.from_numpy(b) for b in batches])]}, timeout=180)
    losses = [r[0]["losses"] for r in results]
    assert losses[0] == losses[1]
    config = jax_train.TrainConfig(learning_rate=1e-2)
    mesh = jax_train.make_mesh(jax.devices()[:2], model_parallel=1)
    params = jax.tree.map(jnp.asarray, npp)
    state = jax_train.place_state(mesh, {
        "params": params,
        "opt_state": jax_train.make_optimizer(config).init(params),
        "step": jnp.zeros((), jnp.int32)})
    step_fn = jax_train.make_train_step(mesh, jcfg, config, state)
    want = []
    for batch in batches:
        state, loss = step_fn(state, jnp.asarray(batch))
        want.append(float(loss))
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)
