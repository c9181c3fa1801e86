"""CLI argument types: Size ("WxH" or named), Range ("start-end"), Offset ("x,y").

Capability parity with reference common/src/size.ml, range.ml, offset.ml.
"""

from __future__ import annotations

import dataclasses
import re

from . import stdsizes


@dataclasses.dataclass(frozen=True)
class Size:
    width: int
    height: int

    @classmethod
    def of_string(cls, s: str) -> "Size":
        if s in stdsizes.SIZES:
            w, h, _ = stdsizes.SIZES[s]
            return cls(w, h)
        parts = s.split("x")
        if len(parts) == 2:
            try:
                return cls(int(parts[0]), int(parts[1]))
            except ValueError:
                pass
        raise ValueError(f"Invalid frame size specified: {s!r}")


@dataclasses.dataclass(frozen=True)
class Range:
    """Frame range: "N" → [N,N], "-N" → [0,N], "A-B" → [A,B]."""

    start: int
    end: int

    @classmethod
    def of_string(cls, s: str) -> "Range":
        parts = re.split(r"[x,\-]", s)
        try:
            if len(parts) == 1:
                v = int(parts[0])
                return cls(v, v)
            if len(parts) == 2 and parts[0] == "":
                return cls(0, int(parts[1]))
            if len(parts) == 2:
                return cls(int(parts[0]), int(parts[1]))
        except ValueError:
            pass
        raise ValueError(f"Invalid frame range specified: {s!r}")


@dataclasses.dataclass(frozen=True)
class Offset:
    x_off: int
    y_off: int

    @classmethod
    def of_string(cls, s: str) -> "Offset":
        parts = re.split(r"[x,\-]", s)
        if len(parts) == 2:
            try:
                return cls(int(parts[0]), int(parts[1]))
            except ValueError:
                pass
        raise ValueError(f"Invalid offset specified: {s!r}")
