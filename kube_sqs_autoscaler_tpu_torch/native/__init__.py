"""Native components of the port: the local queue and the token reader.

The port's own copies of the JAX package's ``native/`` (its C++ sources,
``localqueue.cpp`` and ``tokenreader.cpp``, sit beside this file), bound
with :mod:`ctypes`:

- :class:`LocalQueue`, a native in-process broker that speaks both the
  controller's :class:`~..metrics.queue.QueueService`
  (``get_queue_attributes``) and the workers' ``MessageQueue``
  (``receive_messages`` / ``delete_message``), so the whole autoscaling
  and worker stack runs against it as against SQS;
- :mod:`.tokenreader`, the trainer's mmap corpus reader
  (``--data-dir``).

Build model: one ``g++ -O2 -std=c++17 -shared -fPIC -pthread`` per source
at first use, into ``build/native/`` at the root of the checkout (never
into the package tree), named by a digest of the source and the flags so
an edited source is never served from a stale build.  Concurrent builds
each write a per-process temporary file and the final ``os.replace`` is
atomic.  A failed build raises :class:`NativeUnavailableError`: there is
no Python fallback.  ``extern "C"`` + ctypes releases the GIL during the
native calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

_SRC = Path(__file__).with_name("localqueue.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeUnavailableError(RuntimeError):
    """Raised when the native library cannot be built (no g++)."""


def build_shared_library(src: Path, name: str) -> ctypes.CDLL:
    """Build (unless a build of this exact source is there) and load one
    ``extern "C"`` source as ``build/native/lib<name>-<digest>.so``; the
    build model every native component shares."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib_path.stem}.{os.getpid()}.so.tmp"
        cmd = ["g++", *_FLAGS, str(src), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as err:
            raise NativeUnavailableError(
                f"g++ not found; {src.name} unavailable"
            ) from err
        except subprocess.CalledProcessError as err:
            raise NativeUnavailableError(
                f"native build of {src.name} failed:\n{err.stderr}"
            ) from err
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the native library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_shared_library(_SRC, "localqueue")
        c = ctypes
        lib.lq_create.argtypes = [c.c_double]
        lib.lq_create.restype = c.c_void_p
        lib.lq_destroy.argtypes = [c.c_void_p]
        lib.lq_destroy.restype = None
        lib.lq_close.argtypes = [c.c_void_p]
        lib.lq_close.restype = None
        lib.lq_use_manual_clock.argtypes = [c.c_void_p, c.c_int]
        lib.lq_use_manual_clock.restype = None
        lib.lq_advance.argtypes = [c.c_void_p, c.c_double]
        lib.lq_advance.restype = None
        lib.lq_send.argtypes = [c.c_void_p, c.c_char_p, c.c_longlong, c.c_double]
        lib.lq_send.restype = c.c_longlong
        lib.lq_receive.argtypes = [
            c.c_void_p, c.c_double,
            c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
        ]
        lib.lq_receive.restype = c.c_int
        lib.lq_fetch_body.argtypes = [
            c.c_void_p, c.c_longlong, c.c_char_p, c.c_longlong,
        ]
        lib.lq_fetch_body.restype = c.c_longlong
        lib.lq_delete.argtypes = [c.c_void_p, c.c_longlong]
        lib.lq_delete.restype = c.c_int
        lib.lq_change_visibility.argtypes = [c.c_void_p, c.c_longlong, c.c_double]
        lib.lq_change_visibility.restype = c.c_int
        lib.lq_attributes.argtypes = [c.c_void_p, c.c_longlong * 3]
        lib.lq_attributes.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    """True if the native library is (or can be) built on this machine."""
    try:
        load_library()
        return True
    except NativeUnavailableError:
        return False


class LocalQueue:
    """One native queue.  Implements the controller's ``QueueService`` and
    the workers' ``MessageQueue`` protocols (the ``queue_url`` arguments
    those carry are accepted and ignored — a local queue *is* its handle).
    """

    def __init__(
        self, visibility_timeout: float = 30.0, manual_clock: bool = False
    ) -> None:
        self._lib = load_library()
        self._q = self._lib.lq_create(float(visibility_timeout))
        # active-call refcount: every native entry runs inside _native(),
        # so close() can wait until no thread is inside the C++ object
        # before freeing it (ctypes releases the GIL, so "null the handle
        # first" alone is not enough — a thread can have passed the handle
        # check but not yet entered the C function)
        self._cv = threading.Condition()
        self._active_calls = 0
        if manual_clock:
            self._lib.lq_use_manual_clock(self._q, 1)

    # --- lifecycle -------------------------------------------------------
    @contextmanager
    def _native(self):
        """Yield the handle while holding an active-call ref."""
        with self._cv:
            if self._q is None:
                raise ValueError("operation on closed LocalQueue")
            handle = self._q
            self._active_calls += 1
        try:
            yield handle
        finally:
            with self._cv:
                self._active_calls -= 1
                if self._active_calls == 0:
                    self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            if self._q is None:
                return
            # no new call can acquire the handle past this point
            handle, self._q = self._q, None
        # wake long-pollers (they see `closing` and return -1 promptly) ...
        self._lib.lq_close(handle)
        # ... then wait for every in-flight native call to exit the C++
        # object before freeing it
        with self._cv:
            self._cv.wait_for(lambda: self._active_calls == 0)
        self._lib.lq_destroy(handle)

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "LocalQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- test clock ------------------------------------------------------
    def advance(self, seconds: float) -> None:
        """Advance the queue's manual clock (visibility/delay expiry)."""
        with self._native() as handle:
            self._lib.lq_advance(handle, float(seconds))

    # --- producer --------------------------------------------------------
    def send_message(
        self, queue_url: str = "", body: str = "", delay_s: float = 0.0
    ) -> str:
        data = body.encode()
        with self._native() as handle:
            msg_id = self._lib.lq_send(handle, data, len(data), float(delay_s))
        return f"msg-{msg_id}"

    # --- consumer (workers' MessageQueue protocol) -----------------------
    def receive_messages(
        self, queue_url: str = "", max_messages: int = 1, wait_time_s: int = 0
    ) -> list[dict]:
        out = []
        wait = float(wait_time_s)
        with self._native() as handle:
            for _ in range(max_messages):
                receipt = ctypes.c_longlong()
                length = ctypes.c_longlong()
                status = self._lib.lq_receive(
                    handle, wait, ctypes.byref(receipt), ctypes.byref(length)
                )
                if status != 0:
                    break
                wait = 0.0  # only the first receive of a batch long-polls
                buf = ctypes.create_string_buffer(int(length.value))
                n = self._lib.lq_fetch_body(
                    handle, receipt.value, buf, length.value
                )
                if n < 0:  # expired between receive and fetch (real clock)
                    continue
                out.append(
                    {
                        "ReceiptHandle": f"rh-{receipt.value}",
                        "Body": buf.raw[:n].decode(),
                    }
                )
        return out

    def delete_message(self, queue_url: str = "", receipt_handle: str = "") -> None:
        with self._native() as handle:
            self._lib.lq_delete(handle, self._parse_receipt(receipt_handle))

    def change_message_visibility(
        self, receipt_handle: str, timeout_s: float
    ) -> bool:
        with self._native() as handle:
            status = self._lib.lq_change_visibility(
                handle, self._parse_receipt(receipt_handle), float(timeout_s)
            )
        return status == 0

    # --- controller (QueueService protocol) ------------------------------
    def get_queue_attributes(
        self, queue_url: str = "", attribute_names: list | None = None
    ) -> dict:
        counts = (ctypes.c_longlong * 3)()
        with self._native() as handle:
            self._lib.lq_attributes(handle, counts)
        attributes = {
            "ApproximateNumberOfMessages": str(counts[0]),
            "ApproximateNumberOfMessagesDelayed": str(counts[1]),
            "ApproximateNumberOfMessagesNotVisible": str(counts[2]),
        }
        if attribute_names is None:
            return attributes
        return {
            name: attributes[name]
            for name in attribute_names
            if name in attributes
        }

    @staticmethod
    def _parse_receipt(receipt_handle: str) -> int:
        if receipt_handle.startswith("rh-"):
            try:
                return int(receipt_handle[3:])
            except ValueError:
                return -1  # malformed ("rh-abc") fails like unknown ones
        return -1  # unknown handles fail the delete, mirroring SQS
