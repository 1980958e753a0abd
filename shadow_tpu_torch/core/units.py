"""Typed unit parsing for config values ("10 Mbit", "50 ms", "81920 Kibit").

Mirrors the reference's unit system (src/main/core/support/units.rs): a
numeric value, an optional SI (k/K/M/G/T = powers of 1000) or IEC
(Ki/Mi/Gi/Ti = powers of 1024) prefix, and a base unit for time, bits, or
bytes. Bare integers are accepted where the reference accepts them (e.g.
``stop_time: 10`` means seconds; ``socket_recv_buffer: 174760`` means bytes).
"""

from __future__ import annotations

import re

from shadow_tpu_torch.core import simtime

_SI = {"": 1, "k": 10**3, "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}
_IEC = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}
_PREFIXES = {**_SI, **_IEC}

_TIME_BASE_NS = {
    "ns": 1,
    "nanosecond": 1,
    "nanoseconds": 1,
    "us": simtime.NS_PER_US,
    "μs": simtime.NS_PER_US,
    "microsecond": simtime.NS_PER_US,
    "microseconds": simtime.NS_PER_US,
    "ms": simtime.NS_PER_MS,
    "millisecond": simtime.NS_PER_MS,
    "milliseconds": simtime.NS_PER_MS,
    "s": simtime.NS_PER_SEC,
    "sec": simtime.NS_PER_SEC,
    "secs": simtime.NS_PER_SEC,
    "second": simtime.NS_PER_SEC,
    "seconds": simtime.NS_PER_SEC,
    "min": simtime.NS_PER_MIN,
    "mins": simtime.NS_PER_MIN,
    "minute": simtime.NS_PER_MIN,
    "minutes": simtime.NS_PER_MIN,
    "h": simtime.NS_PER_HOUR,
    "hr": simtime.NS_PER_HOUR,
    "hrs": simtime.NS_PER_HOUR,
    "hour": simtime.NS_PER_HOUR,
    "hours": simtime.NS_PER_HOUR,
}

_NUM_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([A-Za-zμ]*)\s*$")


class UnitParseError(ValueError):
    pass


def _split(text: str) -> tuple[float, str]:
    m = _NUM_RE.match(text)
    if not m:
        raise UnitParseError(f"cannot parse unit value: {text!r}")
    return float(m.group(1)), m.group(2)


def _prefixed(suffix: str, bases: tuple[str, ...]) -> int | None:
    """Return the multiplier if suffix = [prefix] + one of bases, else None."""
    for base in bases:
        if suffix.endswith(base):
            prefix = suffix[: len(suffix) - len(base)]
            if prefix in _PREFIXES:
                return _PREFIXES[prefix]
    return None


def parse_time_ns(value, default_unit: str = "s") -> int:
    """Parse a time value to int64 nanoseconds. Bare numbers use default_unit."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(round(value * _TIME_BASE_NS[default_unit]))
    num, suffix = _split(str(value))
    if suffix == "":
        return int(round(num * _TIME_BASE_NS[default_unit]))
    if suffix not in _TIME_BASE_NS:
        raise UnitParseError(f"unknown time unit {suffix!r} in {value!r}")
    return int(round(num * _TIME_BASE_NS[suffix]))


def parse_bits(value) -> int:
    """Parse a bit quantity (bandwidths) to bits. Bare numbers are bits."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    num, suffix = _split(str(value))
    if suffix == "":
        return int(round(num))
    mult = _prefixed(suffix, ("bit", "bits"))
    if mult is None:
        # Also accept byte units for bandwidth, converting to bits.
        bytes_mult = _prefixed(suffix, ("B", "byte", "bytes"))
        if bytes_mult is None:
            raise UnitParseError(f"unknown bit unit {suffix!r} in {value!r}")
        return int(round(num * bytes_mult * 8))
    return int(round(num * mult))


def parse_bytes(value) -> int:
    """Parse a byte quantity (buffer sizes) to bytes. Bare numbers are bytes."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    num, suffix = _split(str(value))
    if suffix == "":
        return int(round(num))
    mult = _prefixed(suffix, ("B", "byte", "bytes"))
    if mult is None:
        raise UnitParseError(f"unknown byte unit {suffix!r} in {value!r}")
    return int(round(num * mult))
