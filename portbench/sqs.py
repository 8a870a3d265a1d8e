"""The queue the worker drains: SQS's semantics in memory, with its limit
of 10 messages a receive (the port's own SQS client asks for no more), and
a reply queue that keeps what each request was answered.

Every time is read from one clock (``time.perf_counter``); a message's
``SentTimestamp`` is its due time on that clock, in milliseconds.
"""

from __future__ import annotations

import json
import time
from collections import deque

SQS_MAX_RECEIVE = 10


class Queue:
    """Input queue: ``send`` (with a due time), ``receive_messages``,
    ``delete_message``, ``change_message_visibility``.  A delete of a
    request already answered on ``replies`` counts it as answered."""

    def __init__(self, replies: "Replies", clock=time.perf_counter) -> None:
        self.clock = clock
        self.replies = replies
        self._visible: deque = deque()
        self._inflight: dict[str, str] = {}  # receipt handle -> message id
        self._handles = 0
        # message id -> (due, body)
        self.messages: dict[str, tuple[float, str]] = {}
        # message id -> clock time of its delete after a reply
        self.answered: dict[str, float] = {}

    def send(self, message_id: str, body: str, due: float) -> None:
        self.messages[message_id] = (due, body)
        self._visible.append(message_id)

    def depth(self) -> int:
        return len(self._visible)

    def receive_messages(self, queue_url: str, max_messages: int = 1,
                         wait_time_s: int = 0) -> list[dict]:
        out = []
        for _ in range(min(max_messages, SQS_MAX_RECEIVE, len(self._visible))):
            message_id = self._visible.popleft()
            self._handles += 1
            handle = f"rh-{self._handles}"
            self._inflight[handle] = message_id
            due, body = self.messages[message_id]
            out.append({
                "MessageId": message_id, "ReceiptHandle": handle,
                "Body": body,
                "Attributes": {"SentTimestamp": str(int(due * 1000))},
            })
        return out

    def delete_message(self, queue_url: str, receipt_handle: str) -> None:
        message_id = self._inflight.pop(receipt_handle, None)
        if message_id is not None and message_id in self.replies.tokens:
            self.answered.setdefault(message_id, self.clock())

    def change_message_visibility(self, queue_url: str, receipt_handle: str,
                                  visibility_timeout: float) -> None:
        message_id = self._inflight.pop(receipt_handle, None)
        if message_id is not None and visibility_timeout <= 0:
            self._visible.append(message_id)


class Replies:
    """Reply queue: keeps each request's generated tokens (an error reply
    answers nothing)."""

    def __init__(self) -> None:
        self.tokens: dict[str, list[int]] = {}

    def send_message(self, queue_url: str, body: str) -> str:
        payload = json.loads(body)
        rid = payload["request_id"]
        if "tokens" in payload:
            self.tokens.setdefault(rid, payload["tokens"])
        return rid
