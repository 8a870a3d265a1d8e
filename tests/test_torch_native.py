"""The port's native components: the token-corpus reader and the local
queue, built from the port's own C++ copies into ``build/native/``.

Mirrors the reference's ``tests/test_tokenreader.py`` and
``tests/test_native_queue.py`` (not their slow cases), and holds the
port's ``TokenReader`` batches equal to the reference's ``TokenReader``
on the same corpus, seed and step, so a corpus run reads the same
stream in both packages.
"""

import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.native import tokenreader as jax_tokenreader
from kube_sqs_autoscaler_tpu.workloads import data as jax_data
from kube_sqs_autoscaler_tpu_torch import native
from kube_sqs_autoscaler_tpu_torch.native import LocalQueue, tokenreader
from kube_sqs_autoscaler_tpu_torch.native.tokenreader import (
    TokenReader, write_token_shards,
)
from kube_sqs_autoscaler_tpu_torch.workloads import data, model, trainer

torch.set_num_threads(1)


def make_corpus(tmp_path, n_tokens=10_000, vocab=997, shard_tokens=None,
                dtype="uint16", seed=0):
    tokens = np.random.default_rng(seed).integers(0, vocab, n_tokens)
    path = tmp_path / "corpus"
    write_token_shards(path, tokens, vocab, shard_tokens=shard_tokens,
                       dtype=dtype)
    return path, tokens


def test_the_library_builds_outside_the_package_tree():
    lib = tokenreader.load_library()
    assert lib is tokenreader.load_library()  # cached per process
    assert native.native_available()
    built = sorted(p.name for p in native.BUILD_DIR.glob("lib*.so"))
    assert any(n.startswith("libtokenreader-") for n in built)
    assert any(n.startswith("liblocalqueue-") for n in built)
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    package = native.BUILD_DIR.parents[1] / "kube_sqs_autoscaler_tpu_torch"
    assert not list(package.rglob("*.so"))


@pytest.mark.parametrize("shard_tokens,dtype,vocab", [
    (None, "uint16", 997), (1000, "uint16", 997), (2500, "int32", 70_000),
], ids=["one-shard", "ten-shards", "int32"])
def test_batches_equal_the_references(tmp_path, shard_tokens, dtype, vocab):
    path, _ = make_corpus(tmp_path, shard_tokens=shard_tokens, dtype=dtype,
                          vocab=vocab)
    with TokenReader(path, min_window=64) as ours, \
            jax_tokenreader.TokenReader(path, min_window=64) as theirs:
        assert ours.total_tokens == theirs.total_tokens == 10_000
        for seed, step in itertools.product((0, 7), range(4)):
            np.testing.assert_array_equal(ours.batch(4, 64, seed, step),
                                          theirs.batch(4, 64, seed, step))
    # and the trainer's corpus stream, resumed mid-way, is the reference's
    want = jax_data.corpus_token_stream(str(path), 2, 32, seed=3,
                                        start_step=5)
    got = data.corpus_token_stream(str(path), 2, 32, seed=3, start_step=5)
    for a, b in itertools.islice(zip(got, want), 3):
        np.testing.assert_array_equal(a, b)


def test_batches_are_windows_of_the_corpus(tmp_path):
    path, tokens = make_corpus(tmp_path)
    with TokenReader(path, min_window=16) as reader:
        assert reader.total_tokens == len(tokens)
        assert reader.vocab_size == 997
        batch = reader.batch(4, 16, seed=1, step=0)
        assert batch.shape == (4, 16) and batch.dtype == np.int32
        corpus = np.asarray(tokens, np.int32)
        for row in batch:
            starts = np.where(corpus[: len(corpus) - 15] == row[0])[0]
            assert any(np.array_equal(corpus[s:s + 16], row) for s in starts)


def test_determinism_and_step_variation(tmp_path):
    path, _ = make_corpus(tmp_path)
    with TokenReader(path) as a, TokenReader(path) as b:
        x = a.batch(4, 32, seed=7, step=3)
        np.testing.assert_array_equal(x, b.batch(4, 32, seed=7, step=3))
        assert not np.array_equal(x, a.batch(4, 32, seed=7, step=4))
        assert not np.array_equal(x, a.batch(4, 32, seed=8, step=3))
        # sequential steps come from the double buffer and still equal a
        # fresh reader's answer
        for s, got in enumerate([a.batch(2, 16, seed=1, step=s)
                                 for s in range(5)]):
            np.testing.assert_array_equal(got, b.batch(2, 16, seed=1,
                                                       step=s))


def test_windows_never_span_shard_boundaries(tmp_path):
    path, tokens = make_corpus(tmp_path, n_tokens=10_000, shard_tokens=1000)
    shards = [np.asarray(tokens[i:i + 1000], np.int32)
              for i in range(0, 10_000, 1000)]
    with TokenReader(path, min_window=64) as reader:
        for step in range(10):
            for row in reader.batch(4, 64, seed=3, step=step):
                assert any(
                    any(np.array_equal(shard[s:s + 64], row)
                        for s in np.where(shard[:937] == row[0])[0])
                    for shard in shards)


def test_writer_and_reader_refusals(tmp_path):
    with pytest.raises(ValueError, match="uint16"):
        write_token_shards(tmp_path / "c", [1, 2, 3], vocab_size=70_000)
    with pytest.raises(ValueError, match="uint16"):
        write_token_shards(tmp_path / "c", [1, 70_000], vocab_size=65_536)
    with pytest.raises(ValueError, match="negative"):
        write_token_shards(tmp_path / "c", [1, -1], vocab_size=100)
    with pytest.raises(ValueError, match="empty"):
        write_token_shards(tmp_path / "c", [], vocab_size=100)
    with pytest.raises(FileNotFoundError, match="meta.json"):
        TokenReader(tmp_path / "nope")
    path, _ = make_corpus(tmp_path, n_tokens=1000, shard_tokens=100)
    with TokenReader(path) as reader:
        with pytest.raises(ValueError, match="smallest shard"):
            reader.batch(2, 512, seed=0, step=0)
        assert reader.batch(2, 100, seed=0, step=0).shape == (2, 100)
    with pytest.raises(ValueError, match="fewer tokens"):
        TokenReader(path, min_window=1000)


def test_trainer_data_dir_end_to_end(tmp_path):
    path, _ = make_corpus(tmp_path, n_tokens=50_000, vocab=250,
                          shard_tokens=20_000)
    flags = ["--device", "cpu", "--data-dir", str(path), "--batch-size", "4",
             "--seq-len", "32", "--d-model", "64", "--n-heads", "4",
             "--n-layers", "2", "--d-ff", "128", "--vocab-size", "256",
             "--log-every", "1", "--eval-every", "2", "--eval-batches", "1"]
    whole = trainer.main([*flags, "--steps", "4"])
    assert whole["final_step"] == 4 and all(np.isfinite(whole["losses"]))
    # a resumed corpus run reads the uninterrupted run's batches
    ckpt = str(tmp_path / "ckpt")
    first = trainer.main([*flags, "--steps", "2", "--checkpoint-dir", ckpt])
    second = trainer.main([*flags, "--steps", "2", "--checkpoint-dir", ckpt,
                           "--resume"])
    assert first["losses"] + second["losses"] == whole["losses"]
    with pytest.raises(SystemExit, match="vocab"):
        trainer.main([*flags[:-6], "--vocab-size", "128", "--steps", "1"])
    with pytest.raises(SystemExit, match="meta.json"):
        trainer.main(["--device", "cpu", "--data-dir", str(tmp_path / "x"),
                      "--steps", "1"])


def make_queue(**kw):
    kw.setdefault("visibility_timeout", 30.0)
    kw.setdefault("manual_clock", True)
    return LocalQueue(**kw)


def depth3(q):
    attrs = q.get_queue_attributes()
    return tuple(int(attrs[k]) for k in (
        "ApproximateNumberOfMessages", "ApproximateNumberOfMessagesDelayed",
        "ApproximateNumberOfMessagesNotVisible"))


def test_send_receive_delete_visibility_and_delay():
    with make_queue() as q:
        q.send_message(body="hello")
        q.send_message(body="world")
        assert depth3(q) == (2, 0, 0)
        msgs = q.receive_messages(max_messages=2)
        assert [m["Body"] for m in msgs] == ["hello", "world"]
        assert depth3(q) == (0, 0, 2)
        for m in msgs:
            q.delete_message(receipt_handle=m["ReceiptHandle"])
        assert depth3(q) == (0, 0, 0)
        q.send_message(body="task")
        (msg,) = q.receive_messages()
        q.advance(29.0)
        assert q.receive_messages() == []
        q.advance(1.0)
        (again,) = q.receive_messages()
        assert again["Body"] == "task"
        q.delete_message(receipt_handle=msg["ReceiptHandle"])  # stale
        assert depth3(q) == (0, 0, 1)
        q.send_message(body="later", delay_s=10.0)
        assert depth3(q)[1] == 1
        q.advance(10.0)
        assert depth3(q)[0] == 1
        (later,) = q.receive_messages()
        assert q.change_message_visibility(later["ReceiptHandle"], 0.0)
        assert not q.change_message_visibility("rh-99999", 0.0)
        body = "gpu-über-" + "x" * 100_000
        q.send_message(body=body)
        got = [m["Body"] for m in q.receive_messages(max_messages=5)]
        assert body in got


def test_controller_metric_source_reads_the_native_queue():
    from kube_sqs_autoscaler_tpu_torch.metrics.queue import QueueMetricSource

    with make_queue() as q:
        for i in range(5):
            q.send_message(body=f"m{i}")
        q.send_message(body="delayed", delay_s=60.0)
        q.receive_messages()
        assert QueueMetricSource(client=q,
                                 queue_url="local://q").num_messages() == 6


def test_concurrent_producers_consumers_lose_nothing():
    q = LocalQueue(visibility_timeout=60.0)
    total, received, lock = 400, [], threading.Lock()

    def produce(base):
        for i in range(total // 4):
            q.send_message(body=f"{base + i}")

    def consume():
        while True:
            msgs = q.receive_messages(max_messages=10, wait_time_s=1)
            if not msgs:
                return
            with lock:
                received.extend(int(m["Body"]) for m in msgs)
            for m in msgs:
                q.delete_message(receipt_handle=m["ReceiptHandle"])

    threads = [threading.Thread(target=produce, args=(k * 100,))
               for k in range(4)] + [threading.Thread(target=consume)
                                     for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(received) == list(range(total))
    assert depth3(q) == (0, 0, 0)
    q.close()


def test_close_releases_a_long_poller_and_guards_reuse():
    q = LocalQueue(visibility_timeout=30.0)
    t = threading.Thread(target=lambda: q.receive_messages(wait_time_s=5))
    t.start()
    time.sleep(0.2)
    q.close()
    t.join(timeout=3)
    assert not t.is_alive()
    with pytest.raises(ValueError, match="closed"):
        q.send_message(body="x")
    q.close()  # idempotent
    with LocalQueue() as q:
        q.send_message(body="x")
        q.delete_message(receipt_handle="rh-abc")
        q.delete_message(receipt_handle="bogus")
        assert not q.change_message_visibility("rh-12notanint", 0.0)
        assert q.get_queue_attributes()["ApproximateNumberOfMessages"] == "1"


def test_port_queue_worker_drains_the_native_queue():
    from kube_sqs_autoscaler_tpu_torch.workloads.service import (
        QueueWorker, ServiceConfig,
    )

    config = model.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                               n_layers=1, d_ff=64, max_seq_len=32,
                               dtype=torch.float32)
    params = model.init_params(config, torch.Generator().manual_seed(0),
                               "cpu")
    with LocalQueue() as q, LocalQueue() as replies:
        for i in range(6):
            q.send_message(body=json.dumps([i + 1, i + 2, i + 3]))
        worker = QueueWorker(q, params, config, ServiceConfig(
            queue_url="local://q", batch_size=4, seq_len=8,
            generate_tokens=2, result_queue_url="local://r"),
            result_queue=replies, device="cpu")
        while worker.processed < 6:
            worker.run_once()
        assert depth3(q) == (0, 0, 0)
        assert depth3(replies)[0] == 6
