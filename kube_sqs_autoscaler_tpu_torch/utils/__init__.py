"""Utilities the port keeps its own copies of: logging setup and span
timing."""
