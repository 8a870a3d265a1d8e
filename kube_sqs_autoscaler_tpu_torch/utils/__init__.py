"""Utilities the port keeps its own copies of: logging setup, span timing
and device traces, and AWS request signing."""
