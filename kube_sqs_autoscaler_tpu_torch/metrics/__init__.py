"""Queue fakes the port's worker and its tests drive."""

from .fake import FakeMessageQueue

__all__ = ["FakeMessageQueue"]
