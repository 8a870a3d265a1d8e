"""Queues the port's workers and its control loop read: the in-memory fake
the demos and tests drive, the queue-depth metric source, and the AWS SQS
client (standard library only)."""

from .fake import FakeMessageQueue
from .queue import DEFAULT_ATTRIBUTE_NAMES, QueueMetricSource
from .sqs_aws import AwsError, AwsSqsService

__all__ = [
    "DEFAULT_ATTRIBUTE_NAMES",
    "AwsError",
    "AwsSqsService",
    "FakeMessageQueue",
    "QueueMetricSource",
]
