"""The port's checkpoints: save, restore, resume, retention, the manifest,
and the worker serving what the trainer saved.

The port writes its own format (one ``torch.save`` of plain tensors a step,
loadable with ``weights_only=True``), not orbax; the ``model_config.json``
manifest is the reference's byte for byte.  On the CPU a resumed run
equals the uninterrupted one bit for bit: the same AdamW state, the same
batches, the same arithmetic.  Mirrors the reference's
``tests/test_checkpoint.py``, the flat cases of ``test_train_serve.py`` and
``test_trainer.py``'s checkpoint case.
"""

import json

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import checkpoint as jax_checkpoint
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu_torch.workloads import (
    __main__ as worker, checkpoint, llama, model, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
    MODEL_MANIFEST, STATE_FILE, TrainCheckpointer, load_model_layout,
    load_model_manifest, save_model_manifest,
)

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
        "--n-heads", "4", "--n-layers", "2", "--d-ff", "128", "--seq-len",
        "48", "--batch-size", "4", "--learning-rate", "1e-2",
        "--log-every", "1"]
SERVE = ["--device", "cpu", "--demo", "4", "--batch-size", "4", "--seq-len",
         "16", "--generate-tokens", "4", "--result-queue-url",
         "demo://replies"]
CONFIG = model.ModelConfig(vocab_size=256, d_model=64, n_heads=4,
                           n_layers=2, d_ff=128, max_seq_len=32,
                           dtype=torch.float32)


def fresh_state(seed=0):
    return train.train_state(
        model.init_params(CONFIG, torch.Generator().manual_seed(seed), "cpu"),
        train.TrainConfig(learning_rate=1e-2))


def batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (4, 32)).astype(np.int32))
            for _ in range(n)]


def leaves(state):
    return [t.detach().clone() for t in train.param_leaves(state["params"])]


def test_save_restore_resume_is_exact(tmp_path):
    step_fn = train.make_train_step(CONFIG, train.TrainConfig(
        learning_rate=1e-2), "cpu")
    data = batches(6)
    whole = fresh_state()
    whole_losses = [step_fn(whole, b)[1].item() for b in data]

    first = fresh_state()
    losses = [step_fn(first, b)[1].item() for b in data[:3]]
    path = TrainCheckpointer(tmp_path).save(first)
    assert path.name == "step_00000003"
    # one file of plain tensors and ints, loadable without pickled code
    saved = torch.load(path / STATE_FILE, weights_only=True)
    assert set(saved) == {"params", "optimizer", "step"}
    assert saved["step"] == 3 and saved["optimizer"]["count"] == 3
    assert len(saved["optimizer"]["mu"]) == len(train.param_leaves(
        first["params"]))

    resumed = TrainCheckpointer(tmp_path).restore(fresh_state(seed=9))
    assert resumed["step"] == 3
    for a, b in zip(leaves(resumed), leaves(first)):
        assert torch.equal(a, b)
    losses += [step_fn(resumed, b)[1].item() for b in data[3:]]
    assert losses == whole_losses  # bit for bit on the CPU
    for a, b in zip(leaves(resumed), leaves(whole)):
        assert torch.equal(a, b)


def test_latest_step_missing_and_half_written_steps(tmp_path):
    ckpt = TrainCheckpointer(tmp_path)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(fresh_state())
    state = fresh_state()
    state["step"] = 7
    ckpt.save(state, wait=False)
    ckpt.wait_until_finished()
    # a killed writer leaves only a temporary name, which nothing reads
    (tmp_path / "step_00000009.tmp-123").mkdir()
    assert ckpt.latest_step() == 7
    with pytest.raises(FileExistsError):
        ckpt.save(state)


def test_checkpoint_retention_keeps_newest_n(tmp_path):
    ckpt = TrainCheckpointer(tmp_path, keep=2)
    state = fresh_state()
    for step in (1, 2, 3, 4):
        state["step"] = step
        ckpt.save(state, wait=step % 2 == 0)
    ckpt.wait_until_finished()
    assert ckpt._steps() == [3, 4]
    with pytest.raises(ValueError, match="keep"):
        TrainCheckpointer(tmp_path, keep=-1)


def test_trainer_checkpoint_keep_flag(tmp_path):
    ckpt = tmp_path / "ckpt"
    trainer.main([*TINY, "--steps", "6", "--checkpoint-dir", str(ckpt),
                  "--checkpoint-every", "1", "--checkpoint-keep", "2"])
    assert TrainCheckpointer(ckpt)._steps() == [5, 6]


@pytest.mark.parametrize("family,dims,layout", [
    ("gpt", dict(vocab_size=128, d_model=64, n_heads=2, n_layers=1,
                 d_ff=128, max_seq_len=32), None),
    ("llama", dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                   n_layers=1, d_ff=96, max_seq_len=32), None),
    ("llama", dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                   n_layers=1, d_ff=96, max_seq_len=32, sliding_window=8,
                   rms_eps=1e-5), {"kind": "lora", "rank": 4, "seed": 0,
                                   "base": ""}),
    ("gpt", dict(vocab_size=128, d_model=64, n_heads=2, n_layers=1,
                 d_ff=128, max_seq_len=32),
     {"kind": "moe", "n_experts": 4, "top_k": 2}),
], ids=["gpt", "llama", "llama-window-lora", "gpt-moe"])
def test_manifest_is_the_references_byte_for_byte(tmp_path, family, dims,
                                                  layout):
    ref_cls = jax_llama.LlamaConfig if family == "llama" else \
        jax_model.ModelConfig
    port_cls = llama.LlamaConfig if family == "llama" else model.ModelConfig
    jax_checkpoint.save_model_manifest(tmp_path / "ref", family,
                                       ref_cls(**dims), layout=layout)
    save_model_manifest(tmp_path / "port", family, port_cls(**dims),
                        layout=layout)
    want = (tmp_path / "ref" / MODEL_MANIFEST).read_bytes()
    assert (tmp_path / "port" / MODEL_MANIFEST).read_bytes() == want
    # each side reads the other's
    got_family, got = load_model_manifest(tmp_path / "ref")
    assert (got_family, got) == (family, port_cls(**dims))
    assert load_model_layout(tmp_path / "ref") == layout
    ref_family, ref_config = jax_checkpoint.load_model_manifest(
        tmp_path / "port")
    assert (ref_family, ref_config) == (family, ref_cls(**dims))


def test_trainer_checkpoints_and_resumes_as_one_run(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    whole = trainer.main([*TINY, "--steps", "6"])
    first = trainer.main([*TINY, "--steps", "4", "--checkpoint-dir", ckpt,
                          "--checkpoint-every", "2"])
    assert first["final_step"] == 4
    assert TrainCheckpointer(ckpt)._steps() == [2, 4]
    resumed = trainer.main([*TINY, "--steps", "2", "--checkpoint-dir", ckpt,
                            "--resume"])
    assert resumed["final_step"] == 6  # continued, not restarted
    # the resumed run reads the batches the uninterrupted run read next
    assert first["losses"] + resumed["losses"] == whole["losses"]
    for a, b in zip(train.param_leaves(resumed["params"]),
                    train.param_leaves(whole["params"])):
        assert torch.equal(a, b)
    # a directory with steps, without --resume, fails before any training
    with pytest.raises(SystemExit, match="--resume"):
        trainer.main([*TINY, "--steps", "2", "--checkpoint-dir", ckpt])
    # a manifest written by another model refuses the resume
    with pytest.raises(SystemExit, match="different model"):
        trainer.main([*TINY, "--steps", "1", "--checkpoint-dir", ckpt,
                      "--resume", "--d-ff", "64"])


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_worker_serves_trained_weights_end_to_end(tmp_path, family):
    ckpt = str(tmp_path / "ckpt")
    out = trainer.main([*TINY, "--family", family, "--steps", "2",
                        "--checkpoint-dir", ckpt])
    man_family, config = load_model_manifest(ckpt)
    assert man_family == family
    served = TrainCheckpointer(ckpt).restore_params(family, config,
                                                    device="cpu")
    fresh = (llama.init_llama_params if family == "llama"
             else model.init_params)(config, torch.Generator().manual_seed(0),
                                     "cpu")
    # training moved the weights: the worker does not serve the init
    assert any(not torch.equal(a, b) for a, b in zip(
        train.param_leaves(served), train.param_leaves(fresh)))
    for a, b in zip(train.param_leaves(served),
                    train.param_leaves(out["params"])):
        assert torch.equal(a, b)
    # the binary serving the directory replies as serving the trainer's
    # in-memory weights (the manifest's family overrides --family)
    summary = worker.main([*SERVE, "--checkpoint-dir", ckpt])
    direct = worker.run_demo(4, out["params"], config, worker.ServiceConfig(
        queue_url="", batch_size=4, seq_len=16, generate_tokens=4,
        result_queue_url="demo://replies"), torch.device("cpu"))
    assert summary["processed"] == 4
    assert summary["replies"] == direct["replies"]


def test_worker_checkpoint_refusals(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    trainer.main([*TINY, "--steps", "1", "--checkpoint-dir", ckpt])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        worker.main([*SERVE, "--checkpoint-dir", ckpt, "--hf-checkpoint",
                     ckpt])
    # the trained context holds 48 positions
    with pytest.raises(SystemExit, match="max_seq_len=48"):
        worker.main([*SERVE[:-4], "--seq-len", "40", "--generate-tokens",
                     "16", "--checkpoint-dir", ckpt])
    # a pipeline layout serves its stage stacks unstacked (the fused
    # wqkv again); a flat checkpoint that claims the layout has none
    from kube_sqs_autoscaler_tpu_torch.workloads.pipeline import (
        as_pipeline_params,
    )

    _, config = load_model_manifest(ckpt)
    layout = {"kind": "pipeline", "n_stages": 2}
    flat = TrainCheckpointer(ckpt).restore_params("gpt", config,
                                                  device="cpu")
    staged = str(tmp_path / "staged")
    TrainCheckpointer(staged).save({"params": as_pipeline_params(flat),
                                    "step": 1})
    served = TrainCheckpointer(staged).restore_params(
        "gpt", config, layout=layout, device="cpu")
    assert sorted(served) == sorted(flat)
    for a, b in zip(served["layers"], flat["layers"]):
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="no stage stacks"):
        TrainCheckpointer(ckpt).restore_params("gpt", config, layout=layout,
                                               device="cpu")


def test_moe_checkpoint_refuses_to_serve_with_the_references_error(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    trainer.main([*TINY, "--steps", "2", "--moe", "--moe-experts", "4",
                  "--checkpoint-dir", ckpt])
    layout = load_model_layout(ckpt)
    assert layout == {"kind": "moe", "n_experts": 4, "top_k": 2}
    family, config = load_model_manifest(ckpt)
    with pytest.raises(ValueError, match="routed-expert"):
        TrainCheckpointer(ckpt).restore_params(family, config, layout=layout,
                                               device="cpu")
    with pytest.raises(ValueError, match="routed-expert"):
        worker.main([*SERVE, "--checkpoint-dir", ckpt])
    # the MoE state itself resumes
    out = trainer.main([*TINY, "--steps", "1", "--moe", "--moe-experts", "4",
                        "--checkpoint-dir", ckpt, "--resume"])
    assert out["final_step"] == 3


def test_resume_pre_layout_manifest_refuses_with_migration_hint(tmp_path):
    ckpt = tmp_path / "ckpt"
    flags = [*TINY, "--steps", "2", "--moe", "--moe-experts", "4",
             "--checkpoint-dir", str(ckpt)]
    trainer.main(flags)
    manifest = ckpt / MODEL_MANIFEST
    payload = json.loads(manifest.read_text())
    saved_layout = payload.pop("layout")  # a manifest from before the record
    manifest.write_text(json.dumps(payload))
    with pytest.raises(SystemExit, match="model_config.json"):
        trainer.main(flags + ["--resume"])
    payload["layout"] = saved_layout  # the migration the error describes
    manifest.write_text(json.dumps(payload))
    assert trainer.main(flags + ["--resume"])["final_step"] == 4
    # and a dense run of a lora directory fails loudly
    lora = str(tmp_path / "lora")
    trainer.main([*TINY, "--steps", "1", "--lora-rank", "2",
                  "--checkpoint-dir", lora])
    with pytest.raises(SystemExit, match="layout"):
        trainer.main([*TINY, "--steps", "1", "--checkpoint-dir", lora,
                      "--resume"])


def test_restore_checks_shapes(tmp_path):
    TrainCheckpointer(tmp_path).save(fresh_state())
    other = train.train_state(model.init_params(
        model.ModelConfig(vocab_size=256, d_model=32, n_heads=4, n_layers=2,
                          d_ff=128, max_seq_len=32, dtype=torch.float32),
        torch.Generator().manual_seed(0), "cpu"), train.TrainConfig())
    with pytest.raises(ValueError, match="shape"):
        TrainCheckpointer(tmp_path).restore(other)
    assert checkpoint.MODEL_MANIFEST == jax_checkpoint.MODEL_MANIFEST


def test_reference_orbax_checkpoint_is_refused_by_name(tmp_path, capsys):
    """A step the JAX package's trainer wrote (orbax) is refused with a
    message naming the format, by ``load`` and so by ``restore``,
    ``restore_lora`` and ``restore_params``; the worker and the trainer's
    ``--resume`` exit 2 with it, no traceback.  The port imports no JAX
    doing so."""
    import subprocess
    import sys

    from kube_sqs_autoscaler_tpu.workloads import trainer as jax_trainer

    ref = tmp_path / "ref"
    dims = ["--vocab-size", "256", "--d-model", "64", "--n-heads", "4",
            "--n-layers", "2", "--d-ff", "128", "--seq-len", "48",
            "--batch-size", "8"]
    jax_trainer.main([*dims, "--steps", "2", "--checkpoint-dir", str(ref),
                      "--checkpoint-every", "1"])
    saver = TrainCheckpointer(ref)
    assert saver.latest_step() == 2
    assert not (ref / "step_00000002" / STATE_FILE).exists()
    for call in (lambda: saver.load(),
                 lambda: saver.restore(fresh_state()),
                 lambda: saver.restore_params("gpt", CONFIG, device="cpu")):
        with pytest.raises(checkpoint.OrbaxCheckpointError,
                           match="step 2 under .* is an orbax checkpoint of "
                                 "the JAX package"):
            call()
    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_:
        worker.main([*SERVE, "--checkpoint-dir", str(ref)])
    assert exit_.value.code == 2
    assert "orbax checkpoint" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exit_:
        trainer.main([*TINY, "--steps", "1", "--checkpoint-dir", str(ref),
                      "--resume"])
    assert exit_.value.code == 2
    assert "orbax checkpoint" in capsys.readouterr().err
    # without --resume the trainer refuses the directory as before
    with pytest.raises(SystemExit, match="already has step 2"):
        trainer.main([*TINY, "--steps", "1", "--checkpoint-dir", str(ref)])
    # the worker binary as a process with jax unimportable: exit 2, the
    # message, no traceback
    code = ("import sys; sys.modules['jax'] = None; "
            "from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import "
            f"main; main({[*SERVE, '--checkpoint-dir', str(ref)]!r})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2
    assert "orbax checkpoint" in out.stderr and "Traceback" not in out.stderr
