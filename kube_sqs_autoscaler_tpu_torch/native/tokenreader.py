"""ctypes binding for the native token-corpus reader (tokenreader.cpp).

The port's copy of the JAX package's ``native/tokenreader.py``: the same
corpus format (raw ``*.bin`` token shards plus ``meta.json``) and the same
batches for a (seed, step).  Same build model as the local queue (one
``g++`` at first use into ``build/native/``; a failed build raises), with
the GIL released during the native batch copy so the double-buffer
thread's work overlaps the training step's dispatch.
"""

from __future__ import annotations

import ctypes
import json
import threading
from pathlib import Path

import numpy as np

from . import NativeUnavailableError

_SRC = Path(__file__).with_name("tokenreader.cpp")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# metadata file written next to the shards (vocab size + dtype)
META_FILE = "meta.json"


def read_meta(directory: str | Path) -> dict:
    """The corpus metadata (``vocab_size``, ``dtype``) without touching
    the native reader — for cheap validation before shards are mmapped."""
    return json.loads((Path(directory) / META_FILE).read_text())

_OPEN_ERRORS = {
    -1: "bad arguments (no shards, or token dtype not uint16/int32)",
    -2: "shard open() failed",
    -3: "a shard holds fewer tokens than one training window",
    -4: "mmap failed",
}


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from . import build_shared_library

        lib = build_shared_library(_SRC, "tokenreader")
        c = ctypes
        lib.tr_open.argtypes = [
            c.POINTER(c.c_char_p), c.c_longlong, c.c_int, c.c_longlong,
            c.POINTER(c.c_longlong), c.POINTER(c.c_int),
        ]
        lib.tr_open.restype = c.c_void_p
        lib.tr_total_tokens.argtypes = [c.c_void_p]
        lib.tr_total_tokens.restype = c.c_longlong
        lib.tr_fill_batch.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.c_longlong, c.c_longlong,
            c.c_uint64, c.c_longlong,
        ]
        lib.tr_fill_batch.restype = c.c_int
        lib.tr_close.argtypes = [c.c_void_p]
        lib.tr_close.restype = None
        _lib = lib
        return lib


def write_token_shards(
    directory: str | Path,
    tokens,
    vocab_size: int,
    shard_tokens: int | None = None,
    dtype: str = "uint16",
) -> Path:
    """Write a token corpus in the reader's format: ``*.bin`` raw-token
    shards plus ``meta.json`` (vocab size + dtype).  The corpus-prep
    utility for tests, demos, and tokenizer pipelines."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    source = np.asarray(tokens)
    if source.size == 0:
        raise ValueError("empty token corpus (nothing to shard)")
    # validate BEFORE the cast: a silent wrap (old numpy) or an obscure
    # OverflowError (new numpy) would otherwise stand in for these
    # messages — and a wrapped corpus trains on garbage with no error
    # anywhere downstream
    if int(source.min()) < 0:
        raise ValueError(
            f"negative token ids (min {int(source.min())}) are not valid "
            "corpus tokens"
        )
    if dtype == "uint16":
        if vocab_size > 2**16:
            raise ValueError(
                f"vocab_size={vocab_size} does not fit uint16 tokens; "
                "pass dtype='int32'"
            )
        if int(source.max()) >= 2**16:
            raise ValueError(
                "token ids >= 2**16 do not fit uint16 shards; pass "
                "dtype='int32'"
            )
    arr = source.astype(np.uint16 if dtype == "uint16" else np.int32)
    shard_tokens = shard_tokens or len(arr)
    for i, start in enumerate(range(0, len(arr), shard_tokens)):
        (directory / f"shard_{i:05d}.bin").write_bytes(
            arr[start:start + shard_tokens].tobytes()
        )
    (directory / META_FILE).write_text(
        json.dumps({"vocab_size": int(vocab_size), "dtype": dtype}) + "\n"
    )
    return directory


class TokenReader:
    """Deterministic random-crop batches from an mmapped token corpus.

    ``batch(batch, seq, seed, step)`` returns int32 ``[batch, seq]``;
    the (seed, step, row) counter scheme makes every batch a pure
    function of its indices — a resumed trainer re-reads exactly the
    stream it would have seen (no cursor state to checkpoint).  The
    native side double-buffers: step N+1 is assembled on a worker
    thread while step N trains.
    """

    def __init__(self, directory: str | Path, min_window: int = 1):
        directory = Path(directory)
        meta_path = directory / META_FILE
        if not meta_path.exists():
            raise FileNotFoundError(
                f"{meta_path} not found — write shards with "
                "write_token_shards (raw *.bin tokens + meta.json)"
            )
        meta = read_meta(directory)
        self.vocab_size = int(meta["vocab_size"])
        dtype = meta.get("dtype", "uint16")
        if dtype not in ("uint16", "int32"):
            raise ValueError(f"unsupported corpus dtype {dtype!r}")
        paths = sorted(str(p).encode() for p in directory.glob("*.bin"))
        if not paths:
            raise FileNotFoundError(f"no *.bin shards under {directory}")
        self._lib = load_library()
        arr = (ctypes.c_char_p * len(paths))(*paths)
        total = ctypes.c_longlong()
        err = ctypes.c_int()
        self._h = self._lib.tr_open(
            arr, len(paths), 2 if dtype == "uint16" else 4,
            int(min_window), ctypes.byref(total), ctypes.byref(err),
        )
        if not self._h:
            raise ValueError(
                f"tr_open failed for {directory}: "
                f"{_OPEN_ERRORS.get(err.value, err.value)}"
            )
        self.total_tokens = int(total.value)

    def batch(self, batch: int, seq: int, seed: int, step: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        status = self._lib.tr_fill_batch(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            batch, seq, seed & (2**64 - 1), step,
        )
        if status != 0:
            raise ValueError(
                f"batch(seq={seq}) exceeds the smallest shard's tokens "
                "(crops never span shard boundaries) or has a "
                "non-positive shape"
            )
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tr_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
