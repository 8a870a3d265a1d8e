"""In-memory message queue with SQS-like semantics.

The port's copy of ``FakeMessageQueue`` from the JAX package's
``metrics/fake.py``: send/receive/delete with visibility timeouts, so the
worker binary's demo and the tests drive the real queue protocol without
AWS.
"""

from __future__ import annotations

import threading
import time


class FakeMessageQueue:
    """In-memory queue with real message semantics (send/receive/delete).

    Messages have SQS-like visibility: ``receive`` makes a message
    in-flight (counted in ``ApproximateNumberOfMessagesNotVisible``) until
    it is ``delete``d or its visibility timeout lapses.

    Time is injectable (``now_fn``) so visibility timeouts are
    deterministic under a fake clock.
    """

    def __init__(self, visibility_timeout: float = 30.0, now_fn=None):
        self._lock = threading.Lock()
        self._now = now_fn or time.monotonic
        # SentTimestamp base: the injected clock when given (so request
        # ages are deterministic under a FakeClock), else epoch seconds
        # like real SQS — NOT the monotonic visibility clock, whose
        # origin is arbitrary and would not match any consumer's clock
        self._sent_now = now_fn or time.time
        self.visibility_timeout = visibility_timeout
        # (message_id, body, sent_ms) triples
        self._visible: list[tuple[str, str, str]] = []
        # receipt_handle -> (deadline, message_id, body, sent_ms); like
        # real SQS, a fresh receipt handle is issued per receive, so a
        # stale handle from a previous delivery cannot delete a
        # redelivered message
        self._inflight: dict[str, tuple[float, str, str, str]] = {}
        self._message_counter = 0
        self._receipt_counter = 0

    def _requeue_expired(self) -> None:
        now = self._now()
        expired = [
            h for h, (deadline, _, _, _) in self._inflight.items()
            if deadline <= now
        ]
        for handle in expired:
            _, message_id, body, sent = self._inflight.pop(handle)
            self._visible.append((message_id, body, sent))

    def send_message(self, queue_url: str, body: str) -> str:
        with self._lock:
            self._message_counter += 1
            message_id = f"msg-{self._message_counter}"
            # SQS stamps SentTimestamp in epoch milliseconds, as a string
            sent = str(int(self._sent_now() * 1000))
            self._visible.append((message_id, body, sent))
            return message_id

    def receive_messages(
        self, queue_url: str, max_messages: int = 1, wait_time_s: int = 0
    ) -> list[dict]:
        # long polling is a no-op for the in-memory fake: an empty receive
        # returns immediately rather than blocking virtual/real time
        with self._lock:
            self._requeue_expired()
            batch, self._visible = (
                self._visible[:max_messages],
                self._visible[max_messages:],
            )
            deadline = self._now() + self.visibility_timeout
            out = []
            for message_id, body, sent in batch:
                self._receipt_counter += 1
                handle = f"rh-{self._receipt_counter}"
                self._inflight[handle] = (deadline, message_id, body, sent)
                out.append({
                    "MessageId": message_id,
                    "ReceiptHandle": handle,
                    "Body": body,
                    # the attribute surface request-TTL shedding reads
                    "Attributes": {"SentTimestamp": sent},
                })
            return out

    def delete_message(self, queue_url: str, receipt_handle: str) -> None:
        with self._lock:
            self._inflight.pop(receipt_handle, None)

    def change_message_visibility(
        self, queue_url: str, receipt_handle: str, visibility_timeout: float
    ) -> None:
        """Re-deadline one in-flight message (SQS ChangeMessageVisibility).

        ``visibility_timeout=0`` returns the message to the visible queue
        immediately — how a draining worker hands un-finished requests
        back instead of making survivors wait out the full timeout.  A
        stale/unknown handle is a silent no-op, like ``delete_message``.
        """
        with self._lock:
            entry = self._inflight.pop(receipt_handle, None)
            if entry is None:
                return
            _, message_id, body, sent = entry
            if visibility_timeout <= 0:
                self._visible.append((message_id, body, sent))
            else:
                self._inflight[receipt_handle] = (
                    self._now() + visibility_timeout, message_id, body,
                    sent,
                )

    def get_queue_attributes(self, queue_url, attribute_names):
        with self._lock:
            self._requeue_expired()
            return {
                "ApproximateNumberOfMessages": str(len(self._visible)),
                "ApproximateNumberOfMessagesDelayed": "0",
                "ApproximateNumberOfMessagesNotVisible": str(len(self._inflight)),
            }
