"""Go-compatible duration strings.

The port's copy of ``kube_sqs_autoscaler_tpu/utils/duration.py``.

The reference configures every time knob through Go's ``flag.DurationVar``
(``main.go:83-85``), whose accepted syntax is defined by Go's
``time.ParseDuration``: a signed sequence of decimal numbers with optional
fraction, each with a mandatory unit suffix — ``ns``, ``us``/``µs``, ``ms``,
``s``, ``m``, ``h`` — e.g. ``"5s"``, ``"300ms"``, ``"-1.5h"``, ``"2h45m"``.
To keep the CLI surface identical (``--poll-period=5s`` must work verbatim),
this module implements the same grammar.  Durations are represented as float
seconds throughout the framework.
"""

from __future__ import annotations

# Unit suffix -> seconds. Ordering matters only for formatting (largest first).
_UNITS = {
    "h": 3600.0,
    "m": 60.0,
    "s": 1.0,
    "ms": 1e-3,
    "us": 1e-6,
    "µs": 1e-6,  # µs (micro sign)
    "μs": 1e-6,  # μs (greek mu)
    "ns": 1e-9,
}


class DurationError(ValueError):
    """Raised for strings ``time.ParseDuration`` would reject."""


def parse_duration(text: str) -> float:
    """Parse a Go duration string into seconds.

    Mirrors ``time.ParseDuration``: requires a unit on every component
    (``"10"`` is invalid), accepts ``"0"`` bare, accepts a leading sign,
    and sums components left to right.
    """
    if not isinstance(text, str):
        raise DurationError(f"invalid duration: {text!r}")
    s = text.strip()
    original = text
    sign = 1.0
    if s.startswith(("+", "-")):
        if s[0] == "-":
            sign = -1.0
        s = s[1:]
    if s == "0":
        return 0.0
    if not s:
        raise DurationError(f"invalid duration: {original!r}")

    total = 0.0
    i = 0
    n = len(s)
    while i < n:
        # number: integer part and/or fraction
        start = i
        while i < n and (s[i].isdigit() or s[i] == "."):
            i += 1
        num_text = s[start:i]
        if not num_text or num_text == "." or num_text.count(".") > 1:
            raise DurationError(f"invalid duration: {original!r}")
        value = float(num_text)
        # unit: longest match first so "ms" wins over "m"
        unit = None
        for candidate in ("ms", "us", "µs", "μs", "ns", "h", "m", "s"):
            if s.startswith(candidate, i):
                unit = candidate
                break
        if unit is None:
            raise DurationError(
                f"missing or unknown unit in duration: {original!r}"
            )
        i += len(unit)
        total += value * _UNITS[unit]
    return sign * total


def format_duration(seconds: float) -> str:
    """Format seconds as a compact Go-style duration (e.g. ``90.0 -> "1m30s"``).

    Used only for logging/round-tripping; sub-second values print as
    ``ms``/``us``/``ns`` like Go's ``Duration.String``.
    """
    if seconds == 0:
        return "0s"
    sign = "-" if seconds < 0 else ""
    rem = abs(seconds)
    if rem < 1.0:
        for unit, mul in (("ms", 1e-3), ("us", 1e-6), ("ns", 1e-9)):
            if rem >= mul:
                value = rem / mul
                text = f"{value:.6g}"
                return f"{sign}{text}{unit}"
        return f"{sign}{rem / 1e-9:.6g}ns"
    parts = []
    for unit, mul in (("h", 3600.0), ("m", 60.0)):
        if rem >= mul:
            count = int(rem // mul)
            parts.append(f"{count}{unit}")
            rem -= count * mul
    if rem > 0 or not parts:
        text = f"{rem:.6g}"
        parts.append(f"{text}s")
    return sign + "".join(parts)
