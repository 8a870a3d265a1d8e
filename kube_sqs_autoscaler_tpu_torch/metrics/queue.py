"""Attribute-summing queue-depth metric source.

The port's copy of ``kube_sqs_autoscaler_tpu/metrics/queue.py``.

Reference counterpart: ``sqs/sqs.go``.  The "metric" is the sum of a
configured list of string-valued queue attributes fetched in one
``GetQueueAttributes`` call (``sqs/sqs.go:45-67``); with the default
attribute list the depth is visible + delayed + in-flight messages
(``sqs/sqs.go:28-33``).

Two deliberate behavior fixes over the reference (both documented in
SURVEY.md §2.2-C3 / §7.1 step 4):

- An attribute present in the request but missing from the response is an
  explicit :class:`MetricError` instead of the reference's nil-pointer
  dereference at ``sqs/sqs.go:58``.
- A non-integer attribute value raises :class:`MetricError` with the
  reference's context string ``"Failed to get '<attr>' number of messages
  in queue"`` (``sqs/sqs.go:60``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Protocol, Sequence

from ..core.types import MetricError

# sqs/sqs.go:28-33 — default depth = visible + delayed + not-visible.
DEFAULT_ATTRIBUTE_NAMES: tuple[str, ...] = (
    "ApproximateNumberOfMessages",
    "ApproximateNumberOfMessagesDelayed",
    "ApproximateNumberOfMessagesNotVisible",
)

# main.go:28 — the CSV form used as the --attribute-names flag default.
DEFAULT_ATTRIBUTE_NAMES_CSV = ",".join(DEFAULT_ATTRIBUTE_NAMES)


def parse_attribute_names(csv_text: str) -> tuple[str, ...]:
    """Parse the ``--attribute-names`` CSV override (``main.go:103-110``).

    Each item is whitespace-trimmed.  Passing the default CSV verbatim yields
    the canonical default tuple, matching the reference's string-compare fast
    path (behaviorally identical either way, SURVEY.md §2.2-C1).
    """
    if csv_text == DEFAULT_ATTRIBUTE_NAMES_CSV:
        return DEFAULT_ATTRIBUTE_NAMES
    return tuple(item.strip() for item in csv_text.split(","))


class QueueService(Protocol):
    """The provider seam (reference: interface ``SQS``, ``sqs/sqs.go:14-18``).

    One read method is all production needs; the write-side
    ``set_queue_attributes`` lives only on the fake (the reference's
    ``SetQueueAttributes`` is likewise a test-only seam, ``sqs/sqs.go:16``).
    """

    def get_queue_attributes(
        self, queue_url: str, attribute_names: Sequence[str]
    ) -> Mapping[str, str]:
        """Fetch the requested attributes as a name->string-value map."""
        ...


@dataclass
class QueueMetricSource:
    """Sums configured attributes into one integer depth (``sqs/sqs.go:20-24``)."""

    client: QueueService
    queue_url: str
    attribute_names: Sequence[str] = field(default=DEFAULT_ATTRIBUTE_NAMES)

    def num_messages(self) -> int:
        try:
            attributes = self.client.get_queue_attributes(
                self.queue_url, list(self.attribute_names)
            )
        except Exception as err:
            raise MetricError("Failed to get messages in SQS") from err

        messages = 0
        for name in self.attribute_names:
            if name not in attributes:
                # reference nil-derefs here (sqs/sqs.go:58); we error instead
                raise MetricError(
                    f"Failed to get '{name}' number of messages in queue"
                )
            try:
                messages += int(attributes[name])
            except (TypeError, ValueError) as err:
                raise MetricError(
                    f"Failed to get '{name}' number of messages in queue"
                ) from err
        return messages
