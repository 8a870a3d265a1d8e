"""The port's serving over a ``(data, model)`` mesh held against the JAX
package's serving functions on its virtual 8-device CPU mesh.

The port runs as 2 or 4 gloo ranks in spawned processes
(``torch_mesh_ranks.py``, the jobs of ``torch_serve_ranks.py``): every rank
converts the same full weights (the reference's init, through
``convert.params_from_jax``), keeps its slices and serves the same global
batch, its rows over ``data`` and its heads over ``model``.  The
reference's factories run on a mesh of the same shape.

Tolerances: f32 greedy tokens equal the reference's (each greedy
trajectory's top-two margin checked above 1e-4 first, so a flipped token
is a bug and not a near-tie); logits within the reference's own 1e-4; a
sampled mesh run equals the one-process port run for the same generator
seed (JAX's PRNG is not torch's, so sampled tokens are held to the port's
own single-device draws); every rank returns the same global result.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import beam as jax_beam
from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import speculative as jax_spec
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import (
    beam, decode, speculative,
)
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

from .test_torch_decode import top2_margin
from .test_torch_prefix import prefix_ids
from .test_torch_quantize import weights
from .torch_mesh_ranks import run_ranks

torch.set_num_threads(1)

MARGIN = 1e-4
TOKENS = 6
PROMPT = 8
LENGTHS = np.array([8, 5, 8, 6], np.int32)


def prompt_of(family: str, seed: int = 11) -> np.ndarray:
    vocab = 96 if family == "gpt" else 128
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (4, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_mesh(tp: int, world: int = 4):
    return jax_train.make_mesh(jax.devices()[:world], model_parallel=tp,
                               seq_parallel=1)


def reference_margin(family: str, jcfg, jp, prompt, lengths) -> float:
    """The smallest top-two margin of the reference's single-device greedy
    trajectory of ``prompt`` (prefill, then ``TOKENS - 1`` steps)."""
    mod = jax_llama if family == "llama" else jax_decode
    prefill = getattr(mod, "llama_prefill" if family == "llama"
                      else "prefill")
    step = getattr(mod, "llama_decode_step" if family == "llama"
                   else "decode_step")
    logits, cache = prefill(jp, jnp.asarray(prompt), jcfg,
                            lengths=jnp.asarray(lengths))
    margins = []
    for _ in range(TOKENS):
        logits = np.asarray(logits)
        margins.append(top2_margin(logits))
        logits, cache = step(jp, cache, jnp.asarray(logits.argmax(-1),
                                                    jnp.int32), jcfg)
    return float(np.concatenate(margins).min())


def port_prefix(family: str, quantized: bool, window=None):
    _, _, tcfg, tp = weights(family, "float32", window)
    return family_of(tcfg).layout(quantized).prefill_prefix(
        tp, torch.from_numpy(prefix_ids(family)), tcfg, None)


def jax_prefix(family: str, quantized: bool, window=None):
    jcfg, jp, _, _ = weights(family, "float32", window)
    mod = jax_llama if family == "llama" else jax_decode
    base = "prefill_prefix"
    if quantized:
        base = "quantized_" + base
    if family == "llama":
        base = "llama_" + base
    return getattr(mod, base)(jp, jnp.asarray(prefix_ids(family)), jcfg)


# ---------------------------------------------------------------------------
# the jobs, one rank call per world size
# ---------------------------------------------------------------------------

# job name -> (world, family, window, job keywords); the inputs are filled
# in by ``_job``
GENERATE = {
    "gpt-tp2": (4, "gpt", None, dict(tp=2, logits=True)),
    "gpt-tp2-int8-cache": (4, "gpt", None, dict(tp=2, quantized=True)),
    "gpt-tp2-prefix": (4, "gpt", None, dict(tp=2, prefix=True)),
    "gpt-tp2-prefix-int8": (4, "gpt", None, dict(tp=2, prefix=True,
                                                 quantized=True)),
    "gpt-tp1-dp4": (4, "gpt", None, dict(tp=1)),
    "gpt-int8-weights": (4, "gpt", None, dict(tp=2, int8_weights=True)),
    "llama-tp2": (4, "llama", None, dict(tp=2, logits=True)),
    "llama-window-tp2": (4, "llama", 4, dict(tp=2)),
    "llama-tp2-int8-prefix": (4, "llama", None, dict(tp=2, prefix=True,
                                                     quantized=True)),
    "gpt-tp2-dp1": (2, "gpt", None, dict(tp=2, logits=True)),
    "llama-tp2-dp1": (2, "llama", None, dict(tp=2)),
}
BEAM = {
    "gpt": (4, "gpt", None, dict(tp=2, beams=3)),
    "llama": (4, "llama", None, dict(tp=2, beams=2, length_penalty=0.6)),
    "gpt-prefix-int8": (4, "gpt", None, dict(tp=2, beams=2, prefix=True,
                                             quantized=True)),
    "gpt-dp1": (2, "gpt", None, dict(tp=2, beams=2)),
}
SPECULATIVE = {
    "gpt": (4, "gpt", None, dict(tp=2, draft_layers=1, draft_tokens=2)),
    "llama": (4, "llama", None, dict(tp=2, draft_layers=1, draft_tokens=3)),
    "gpt-prefix-int8": (4, "gpt", None, dict(tp=2, draft_layers=1,
                                             draft_tokens=2, prefix=True,
                                             quantized=True)),
    "gpt-sampled": (4, "gpt", None, dict(tp=2, draft_layers=1,
                                         draft_tokens=2, temperature=0.8,
                                         seed=5)),
}
FORWARD = {
    "gpt": (4, "gpt", None, dict(tp=2)),
    "llama-window": (4, "llama", 4, dict(tp=2)),
}


@functools.lru_cache(maxsize=None)
def eos_of(family: str, window=None) -> int:
    """An eos id that fires early on the reference's greedy run of row
    0 (its second token)."""
    out = reference_generate(family, window, 2, prompt_of(family), LENGTHS,
                             False, False, (0.0, 0, None))
    return int(out[0, 1])


def _job(kind: str, family: str, window, spec: dict) -> dict:
    _, _, tcfg, tp = weights(family, "float32", window)
    spec = dict(spec)
    job = dict(kind=kind, family=family, config=tcfg, params=tp,
               prompt=torch.from_numpy(prompt_of(family)),
               lengths=torch.from_numpy(LENGTHS), tokens=TOKENS)
    if spec.pop("prefix", False):
        job["prefix_cache"] = port_prefix(family, spec.get("quantized",
                                                           False), window)
    job.update(spec)
    return job


def generate_runs(family: str, window=None) -> list:
    """``(temperature, top_k, eos_id, seed)`` of each generate run: greedy,
    greedy with eos, a sampled run twice, sampled top-k 1."""
    return [(0.0, 0, None, None), (0.0, 0, eos_of(family, window), None),
            (0.9, 0, None, 3), (0.9, 0, None, 3), (0.9, 1, None, 4)]


def all_jobs(world: int) -> tuple[list, list]:
    """Every job of ``world`` ranks and its ``(table, name)``."""
    jobs, names = [], []
    for table, kind in ((GENERATE, "generate"), (BEAM, "beam"),
                        (SPECULATIVE, "speculative"),
                        (FORWARD, "forward")):
        for name, (w, family, window, spec) in table.items():
            if w != world:
                continue
            job = _job(kind, family, window, spec)
            if kind == "generate":
                job["runs"] = generate_runs(family, window)
            if kind == "beam":
                job["eos_id"] = eos_of(family, window)
            jobs.append(job)
            names.append((kind, name))
    if world == 4:
        _, _, tcfg, tp = weights("gpt")
        _, _, lcfg, lp = weights("llama")
        jobs.append(dict(kind="refusals", config=tcfg, params=tp,
                         prefix_cache=port_prefix("gpt", False)))
        names.append(("refusals", "gpt"))
        jobs.append(dict(kind="refused_batcher", config=tcfg, params=tp,
                         llama_config=lcfg, llama_params=lp))
        names.append(("refused_batcher", "gpt"))
    return jobs, names


_done: dict = {}


def port(kind: str, name: str):
    """Every rank's result of job ``(kind, name)``; the world's rank call
    runs once with every job of that world."""
    tables = {"generate": GENERATE, "beam": BEAM,
              "speculative": SPECULATIVE, "forward": FORWARD}
    world = tables[kind][name][0] if kind in tables else 4
    if world not in _done:
        jobs, names = all_jobs(world)
        results = run_ranks("serve", world, {"jobs": jobs}, timeout=400)
        _done[world] = {key: [r[i] for r in results]
                        for i, key in enumerate(names)}
    return _done[world][(kind, name)]


def same_on_every_rank(results: list, key: str):
    first = results[0][key]
    for r in results[1:]:
        if isinstance(first, list):
            for a, b in zip(first, r[key]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            torch.testing.assert_close(first, r[key], rtol=0, atol=0)
    return first


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def reference_generate(family, window, tp, prompt, lengths, quantized,
                       prefix, run, int8=False, world=4):
    jcfg, jp, _, _ = weights(family, "float32", window, int8)
    make = (jax_llama.make_llama_serving_fns if family == "llama"
            else jax_decode.make_serving_fns)
    pc = jax_prefix(family, quantized, window) if prefix else None
    _, _, gen = make(jax_mesh(tp, world), jcfg, jp,
                     quantized_cache=quantized, prefix_cache=pc)
    temperature, top_k, eos = run
    return np.asarray(gen(jp, jnp.asarray(prompt), jax.random.key(0),
                          jnp.asarray(lengths), TOKENS, temperature, top_k,
                          1.0, eos))


def one_process_generate(family, window, prompt, lengths, run):
    """The port's single-device generate of one run (the sampled runs'
    oracle)."""
    _, _, tcfg, tp = weights(family, "float32", window)
    temperature, top_k, eos, seed = run
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    return family_of(tcfg).generate(
        tp, torch.from_numpy(prompt), TOKENS, tcfg, None,
        temperature=temperature, generator=generator,
        lengths=torch.from_numpy(lengths), top_k=top_k, eos_id=eos)


# ---------------------------------------------------------------------------
# make_serving_fns / make_llama_serving_fns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GENERATE))
def test_mesh_generate_matches_the_reference_mesh(name):
    world, family, window, spec = GENERATE[name]
    jcfg, jp, _, _ = weights(family, "float32", window)
    prompt = prompt_of(family)
    assert reference_margin(family, jcfg, jp, prompt, LENGTHS) > MARGIN
    results = port("generate", name)
    got = same_on_every_rank(results, "generate")
    runs = generate_runs(family, window)
    plain = not (spec.get("quantized") or spec.get("prefix")
                 or spec.get("int8_weights"))
    for i, run in enumerate(runs):
        if run[0] > 0.0:
            # sampled: the one-process port run of the same seed, draw
            # for draw (the plain layout's oracle)
            if plain:
                want = one_process_generate(family, window, prompt, LENGTHS,
                                            run)
                np.testing.assert_array_equal(got[i].numpy(), want.numpy())
            continue
        want = reference_generate(
            family, window, spec["tp"], prompt, LENGTHS,
            spec.get("quantized", False), spec.get("prefix", False),
            run[:3], spec.get("int8_weights", False), world)
        np.testing.assert_array_equal(got[i].numpy(), want)
    # sampled runs of one seed repeat; top-k 1 is greedy
    np.testing.assert_array_equal(got[2].numpy(), got[3].numpy())
    np.testing.assert_array_equal(got[4].numpy(), got[0].numpy())
    if plain:
        # the eos fired early on row 0 and pinned the rest of it
        eos = runs[1][2]
        row = got[1][0].numpy()
        hits = np.flatnonzero(row == eos)
        assert hits.size and (row[hits[0]:] == eos).all()


@pytest.mark.parametrize("name", ["gpt-tp2", "llama-tp2", "gpt-tp2-dp1"])
def test_mesh_prefill_and_decode_logits_match_the_reference(name):
    world, family, window, spec = GENERATE[name]
    jcfg, jp, tcfg, _ = weights(family, "float32", window)
    results = port("generate", name)
    prompt = prompt_of(family)
    make = (jax_llama.make_llama_serving_fns if family == "llama"
            else jax_decode.make_serving_fns)
    prefill, step, _ = make(jax_mesh(2, world), jcfg, jp)
    want_logits, cache = prefill(jp, jnp.asarray(prompt))
    nxt = jnp.argmax(want_logits, axis=-1).astype(jnp.int32)
    want_step, _ = step(jp, cache, nxt)
    for r in results:
        np.testing.assert_allclose(r["prefill"].numpy(),
                                   np.asarray(want_logits), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(r["next"].numpy(), np.asarray(nxt))
        np.testing.assert_allclose(r["step"].numpy(), np.asarray(want_step),
                                   rtol=1e-4, atol=1e-4)
        # the rank's cache: its rows over data, its heads over model
        heads = (tcfg.n_kv_heads if family == "llama" else tcfg.n_heads)
        assert r["cache_heads"] == heads // spec["tp"]
        assert r["cache_rows"] == 4 // (world // spec["tp"])


def test_serving_mesh_refusals_are_the_references():
    (result,) = port("refusals", "gpt")[:1]
    assert result["seq"].startswith(
        "serving uses a (data, model) mesh; got seq=2")
    assert "layout mismatch" in result["layout"]
    jcfg, jp, _, _ = weights("gpt")
    with pytest.raises(ValueError) as err:
        jax_decode.make_serving_fns(
            jax_train.make_mesh(jax.devices()[:4], model_parallel=2,
                                seq_parallel=2), jcfg, jp)
    assert str(err.value) == result["seq"]


# ---------------------------------------------------------------------------
# beams, speculative decoding, the forward step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BEAM))
def test_mesh_beam_search_matches_the_reference_mesh(name):
    world, family, window, spec = BEAM[name]
    jcfg, jp, _, _ = weights(family, "float32", window)
    prompt = prompt_of(family)
    quantized = spec.get("quantized", False)
    pc = jax_prefix(family, quantized, window) if spec.get("prefix") else None
    run = jax_beam.make_beam_serving_fn(
        jax_mesh(spec["tp"], world), jcfg, jp, beams=spec["beams"],
        length_penalty=spec.get("length_penalty", 0.0),
        eos_id=eos_of(family, window), prefix_cache=pc,
        quantized_cache=quantized)
    want = np.asarray(run(jp, jnp.asarray(prompt), jnp.asarray(LENGTHS),
                          TOKENS))
    got = same_on_every_rank(port("beam", name), "tokens")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(SPECULATIVE))
def test_mesh_speculative_matches_the_reference_mesh(name):
    world, family, window, spec = SPECULATIVE[name]
    jcfg, jp, tcfg, tp = weights(family, "float32", window)
    prompt = prompt_of(family)
    got = same_on_every_rank(port("speculative", name), "tokens")
    if spec.get("temperature", 0.0) > 0.0:
        # sampled: the one-process port run of the same seed
        draft_params, draft_config = speculative.self_draft(
            tp, tcfg, spec["draft_layers"])
        want = speculative.speculative_generate(
            tp, tcfg, draft_params, draft_config, torch.from_numpy(prompt),
            TOKENS, draft_tokens=spec["draft_tokens"],
            lengths=torch.from_numpy(LENGTHS),
            temperature=spec["temperature"],
            generator=torch.Generator().manual_seed(spec["seed"]))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return
    from dataclasses import replace

    quantized = spec.get("quantized", False)
    pc = jax_prefix(family, quantized, window) if spec.get("prefix") else None
    draft_cfg = replace(jcfg, n_layers=spec["draft_layers"])
    run = jax_spec.make_speculative_serving_fn(
        jax_mesh(spec["tp"], world), jcfg, jp, draft_cfg,
        draft_tokens=spec["draft_tokens"], prefix_cache=pc,
        quantized_cache=quantized)
    want = np.asarray(run(jp, dict(jp, layers=jp["layers"][
        :spec["draft_layers"]]), jnp.asarray(prompt), jnp.asarray(LENGTHS),
        jax.random.key(0), TOKENS))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(FORWARD))
def test_mesh_forward_step_matches_the_reference_mesh(name):
    world, family, window, spec = FORWARD[name]
    jcfg, jp, _, _ = weights(family, "float32", window)
    fwd = jax_train.make_forward_step(
        jax_mesh(spec["tp"], world), jcfg, jp,
        forward_fn=jax_llama.llama_forward if family == "llama" else None)
    want = np.asarray(fwd(jp, jnp.asarray(prompt_of(family))))
    got = same_on_every_rank(port("forward", name), "logits")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the port's own pieces
# ---------------------------------------------------------------------------


def test_the_engines_refuse_a_mesh_as_the_reference():
    result = port("refused_batcher", "gpt")[0]
    assert result["rows"] == ("batch_size 3 not divisible by the mesh's "
                              "data axis (4)")
    assert result["seq"].startswith("serving uses a (data, model) mesh")
    assert result["shards"] == ("shards (3) not divisible by the mesh's "
                                "data axis (4)")
    assert result["spec_plane"].startswith(
        "the speculative decode plane is single-chip for now")
    assert result["pool_heads"].startswith(
        "prefix pool KV heads (2) not divisible by the mesh's model axis "
        "(4)")


def test_sampling_draw_equals_one_multinomial_over_the_batch():
    probs = torch.softmax(torch.randn(6, 40,
                                      generator=torch.Generator()
                                      .manual_seed(1)), dim=-1)
    whole = torch.multinomial(probs, 1, generator=torch.Generator()
                              .manual_seed(9))[:, 0]
    for start in (0, 2, 4):
        part = decode.sample_rows(probs[start:start + 2],
                                  torch.Generator().manual_seed(9),
                                  (start, 6))
        np.testing.assert_array_equal(part.numpy(),
                                      whole[start:start + 2].numpy())


def test_prefix_cache_shardings_hold_a_rank_heads():
    from types import SimpleNamespace

    for quantized in (False, True):
        full = port_prefix("gpt", quantized)
        axes = {"model": SimpleNamespace(size=2, index=1)}
        mesh = SimpleNamespace(axis=axes.__getitem__,
                               device=torch.device("cpu"))
        shard = decode.prefix_cache_shardings(mesh, full)
        for got, want in zip(shard["layers"], full["layers"]):
            assert got.keys() == want.keys()
            for name, leaf in want.items():
                # the batch-1 row whole, the second half of the heads
                torch.testing.assert_close(got[name],
                                           leaf[:, leaf.shape[1] // 2:])
        torch.testing.assert_close(shard["length"], full["length"])


def test_quantized_weights_slice_with_their_scales():
    from kube_sqs_autoscaler_tpu_torch.workloads import quantize, train

    _, _, tcfg, tp = weights("gpt")
    q = quantize.quantize_params(tp)
    layer = q["layers"][0]
    for name, dim in (("wqkv", 1), ("wo", 0), ("w_up", 1), ("w_down", 0)):
        spec = train.param_spec(name)
        part = train.slice_param(layer[name], spec, 2, 1)
        assert part.codes.shape[dim] == layer[name].codes.shape[dim] // 2
        full = train.slice_param(layer[name].dequantize(), spec, 2, 1)
        torch.testing.assert_close(part.dequantize(), full, rtol=0, atol=0)
