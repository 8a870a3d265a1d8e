"""The port's Hugging Face import and export held against ``transformers``.

Mirrors the reference's ``tests/test_hf_convert.py`` (all but its mesh
case): tiny randomly initialized ``LlamaForCausalLM`` / ``MistralForCausalLM``
models built in the test (no download; the hub is never asked), fp32
everywhere, so the tolerance is float reassociation (2e-4, the
reference's).  The converted logits and greedy tokens against
``transformers``' own forward, tied and untied, Llama and Mistral; the
export round trip; the port's and the reference's conversions equal; the
worker serving an HF directory and a tokenizer directory (built here
with the ``tokenizers`` package); the trainer's ``--hf-checkpoint`` with
``--lora-rank`` and ``--hf-export``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import hf_convert as jax_hf
from kube_sqs_autoscaler_tpu_torch.workloads import (
    __main__ as worker, hf_convert, llama, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
    load_model_layout,
)

os.environ.setdefault("HF_HUB_OFFLINE", "1")
transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)


def make_hf(tie: bool, rms_eps: float = 1e-6, seed: int = 0,
            window: int | None = None):
    torch.manual_seed(seed)
    common = dict(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=rms_eps,
        tie_word_embeddings=tie, attn_implementation="eager",
    )
    if window is not None:
        model = transformers.MistralForCausalLM(transformers.MistralConfig(
            sliding_window=window, **common))
    else:
        model = transformers.LlamaForCausalLM(
            transformers.LlamaConfig(**common))
    model.eval()
    return model


def hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids).long()).logits.float().numpy()


def ids(batch=2, seq=12, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (batch, seq)).astype(
        np.int32)


@pytest.mark.parametrize("tie,window", [(True, None), (False, None),
                                        (True, 6)],
                         ids=["llama-tied", "llama-untied", "mistral-w6"])
def test_converted_logits_match_transformers(tie, window):
    model = make_hf(tie, rms_eps=1e-6 if tie else 1e-5, window=window)
    config, params = hf_convert.load_hf_llama(model, dtype=torch.float32,
                                              device="cpu")
    assert config.rms_eps == model.config.rms_norm_eps
    assert config.sliding_window == window
    assert ("lm_head" in params) == (not tie)
    tokens = ids()
    ours = llama.llama_forward(params, torch.from_numpy(tokens), config)
    np.testing.assert_allclose(ours.numpy(), hf_logits(model, tokens),
                               rtol=2e-4, atol=2e-4)
    # the reference's conversion of the same model gives the same weights
    _, want = jax_hf.load_hf_llama(model, dtype=jnp.float32)
    got = train.param_leaves(params)
    want_leaves = [np.asarray(want[k]) for k in sorted(want)
                   if k != "layers"] + [
        np.asarray(layer[k]) for layer in want["layers"]
        for k in sorted(layer)]
    for g, w in zip(got, want_leaves):
        np.testing.assert_array_equal(g.numpy(), w)


def test_converted_greedy_generation_matches_transformers():
    model = make_hf(tie=True, seed=3)
    config, params = hf_convert.load_hf_llama(model, dtype=torch.float32,
                                              device="cpu")
    prompt = ids(2, 8, seed=2)
    ours = llama.llama_generate(params, torch.from_numpy(prompt), 8, config)
    with torch.no_grad():
        theirs = model.generate(
            torch.from_numpy(prompt).long(), max_new_tokens=8,
            do_sample=False, num_beams=1, pad_token_id=0,
        )[:, prompt.shape[1]:].numpy()
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_state_dict_conversion_accepts_numpy_and_round_trips():
    model = make_hf(tie=False, seed=13)
    config = hf_convert.llama_config_from_hf(model.config,
                                             dtype=torch.float32)
    state = {k: v.detach().float().numpy()
             for k, v in model.state_dict().items()}
    params = hf_convert.llama_params_from_hf(state, config, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    np.testing.assert_allclose(
        llama.llama_forward(params, torch.from_numpy(tokens),
                            config).numpy(),
        hf_logits(model, tokens), rtol=2e-4, atol=2e-4)
    back = hf_convert.hf_state_dict_from_llama(params, config)
    assert set(back) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    with pytest.raises(ValueError, match="head_dim"):
        bad = transformers.LlamaConfig(hidden_size=64, num_attention_heads=4,
                                       head_dim=32)
        hf_convert.llama_config_from_hf(bad)


@pytest.mark.parametrize("window", [None, 8], ids=["llama", "mistral"])
def test_exported_model_matches_our_forward(tmp_path, window):
    config = llama.LlamaConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_kv_heads=2, n_layers=2, d_ff=96,
                               max_seq_len=64, sliding_window=window,
                               dtype=torch.float32)
    params = llama.init_llama_params(config, torch.Generator().manual_seed(5),
                                     "cpu")
    hf_convert.save_hf_llama(params, config, tmp_path / "exported")
    # the directory loads back through transformers and through the port
    reloaded_config, reloaded = hf_convert.load_hf_llama(
        tmp_path / "exported", dtype=torch.float32, device="cpu")
    assert reloaded_config == config
    for a, b in zip(train.param_leaves(params),
                    train.param_leaves(reloaded)):
        assert torch.equal(a, b)
    model_cls = (transformers.MistralForCausalLM if window
                 else transformers.LlamaForCausalLM)
    theirs = model_cls.from_pretrained(tmp_path / "exported",
                                       local_files_only=True).eval()
    tokens = ids(seed=3)
    np.testing.assert_allclose(
        llama.llama_forward(params, torch.from_numpy(tokens),
                            config).numpy(),
        hf_logits(theirs, tokens), rtol=2e-4, atol=2e-4)


def test_worker_serves_an_hf_checkpoint(tmp_path):
    model = make_hf(tie=True, seed=11)
    model.save_pretrained(tmp_path / "hf")
    argv = ["--device", "cpu", "--demo", "2", "--batch-size", "2",
            "--seq-len", "8", "--generate-tokens", "4",
            "--result-queue-url", "demo://replies"]
    summary = worker.main([*argv, "--hf-checkpoint", str(tmp_path / "hf")])
    assert summary["processed"] == 2
    # the replies are the model's own greedy continuations
    config, params = hf_convert.load_hf_llama(tmp_path / "hf", device="cpu")
    direct = worker.run_demo(2, params, config, worker.ServiceConfig(
        queue_url="", batch_size=2, seq_len=8, generate_tokens=4,
        result_queue_url="demo://replies"), torch.device("cpu"))
    assert summary["replies"] == direct["replies"]
    with pytest.raises(SystemExit, match="max_seq_len=64"):
        worker.main([*argv[:-4], "--seq-len", "60", "--generate-tokens",
                     "8", "--hf-checkpoint", str(tmp_path / "hf")])


def make_tokenizer_dir(path):
    """A word-level tokenizer over 60 words, saved as a transformers
    tokenizer directory (no download)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<unk>", "</s>"] + [f"w{i}" for i in range(58)]
    backend = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                         unk_token="<unk>"))
    backend.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=backend, unk_token="<unk>", eos_token="</s>")
    fast.save_pretrained(path)
    return fast


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["batch", "continuous"])
def test_worker_tokenizer_text_in_text_out(tmp_path, continuous):
    fast = make_tokenizer_dir(tmp_path / "tok")
    argv = ["--device", "cpu", "--demo", "3", "--batch-size", "4",
            "--seq-len", "16", "--generate-tokens", "4",
            "--result-queue-url", "demo://replies", "--family", "llama",
            "--tokenizer", str(tmp_path / "tok")]
    if continuous:
        argv += ["--continuous", "--decode-block", "2"]
    summary = worker.main(argv)
    assert summary["processed"] == 3
    for reply in summary["replies"].values():
        # the eos id came from the tokenizer, and the text is the decode
        assert 1 not in reply["tokens"]
        assert reply["text"] == fast.decode(reply["tokens"])


def test_tokenizer_bodies_encode_and_refusals(tmp_path):
    from kube_sqs_autoscaler_tpu_torch.workloads import service

    fast = make_tokenizer_dir(tmp_path / "tok")
    for body in ("w3 w4 w5", json.dumps("w3 w4 w5"),
                 json.dumps({"text": "w3 w4 w5"})):
        np.testing.assert_array_equal(
            service.parse_request_body(body, fast), [5, 6, 7])
    np.testing.assert_array_equal(service.parse_request_body("[1, 2]", fast),
                                  [1, 2])
    assert service.parse_request_body("w3", None) is None
    assert service.build_token_reply([5, 6, 1, 0], 1, fast) == {
        "tokens": [5, 6], "text": "w3 w4"}
    tenant, _, got = service.parse_tenant_request(
        json.dumps({"tenant": "a", "text": "w9"}), tokenizer=fast)
    assert tenant == "a" and got.tolist() == [11]
    # the built-in GPT's vocabulary holds the tokenizer's; a 32-token
    # vocabulary does not
    with pytest.raises(SystemExit, match="not a directory"):
        worker.main(["--device", "cpu", "--demo", "1", "--tokenizer",
                     str(tmp_path / "missing")])
    config = llama.LlamaConfig(vocab_size=32, d_model=32, n_heads=2,
                               n_kv_heads=1, n_layers=1, d_ff=32,
                               max_seq_len=32)
    args = worker.build_parser().parse_args(["--tokenizer",
                                             str(tmp_path / "tok")])
    with pytest.raises(SystemExit, match="exceeds the model's vocab_size"):
        worker.load_tokenizer(args, config, worker.ServiceConfig(
            queue_url=""))


def test_trainer_lora_on_an_hf_base_serves_merged(tmp_path):
    make_hf(tie=True, seed=0).save_pretrained(tmp_path / "hf")
    ckpt = tmp_path / "trained"
    out = trainer.main([
        "--device", "cpu", "--hf-checkpoint", str(tmp_path / "hf"),
        "--lora-rank", "4", "--steps", "3", "--batch-size", "8",
        "--seq-len", "16", "--checkpoint-dir", str(ckpt),
        "--checkpoint-every", "0", "--log-every", "1", "--overfit",
        "--learning-rate", "1e-2"])
    assert out["final_step"] == 3 and out["losses"][-1] < out["losses"][0]
    assert load_model_layout(ckpt) == {
        "kind": "lora", "rank": 4, "seed": 0, "base": str(tmp_path / "hf")}
    summary = worker.main(["--device", "cpu", "--checkpoint-dir", str(ckpt),
                           "--demo", "2", "--batch-size", "1", "--seq-len",
                           "8", "--generate-tokens", "4"])
    assert summary["processed"] == 2
    with pytest.raises(SystemExit, match="does not combine"):
        trainer.main(["--device", "cpu", "--hf-checkpoint",
                      str(tmp_path / "hf"), "--family", "llama",
                      "--sliding-window", "4"])


def test_trainer_hf_export_flag(tmp_path):
    out = trainer.main([
        "--device", "cpu", "--family", "llama", "--steps", "2",
        "--batch-size", "4", "--seq-len", "16", "--d-model", "64",
        "--n-heads", "4", "--n-kv-heads", "2", "--n-layers", "2",
        "--vocab-size", "128", "--log-every", "1", "--lora-rank", "2",
        "--hf-export", str(tmp_path / "hf_out")])
    exported = transformers.LlamaForCausalLM.from_pretrained(
        tmp_path / "hf_out", local_files_only=True)
    assert exported.config.num_hidden_layers == 2
    # the export holds the run's final (merged) weights
    config, params = hf_convert.load_hf_llama(tmp_path / "hf_out",
                                              device="cpu")
    for a, b in zip(train.param_leaves(params),
                    train.param_leaves(out["params"])):
        assert torch.equal(a, b)
