"""Stream sources: where the trainer's rounds come from.

Counterpart of the synchronous part of ``repro.api.streams``. A stream is
a dict of numpy arrays stacked over rounds, e.g.
``{"tokens": (R, b, s), "labels": (R, b, s)}``; ``take(n)`` pops up to
``n`` rounds exactly once. The reference's prefetching, replay-buffered
feeder is a later slice; ``SegmentFeeder`` pulls segments synchronously.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import numpy as np

Batch = Dict[str, np.ndarray]


class StreamSource:
    """Base protocol; subclasses implement ``take`` and ``remaining``."""

    @property
    def remaining(self) -> Optional[int]:
        """Rounds not yet consumed, or ``None`` when unbounded/unknown."""
        raise NotImplementedError

    def take(self, n: int) -> Optional[Batch]:
        """Pop up to ``n`` rounds stacked as ``{k: (m, b, ...)}``, m ≤ n;
        ``None`` once the source is exhausted."""
        raise NotImplementedError


class ArrayStreamSource(StreamSource):
    """Finite stream backed by stacked arrays, with a consumption cursor."""

    def __init__(self, arrays: Batch):
        if not arrays:
            raise ValueError("empty stream dict")
        lens = {k: v.shape[0] for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"inconsistent round counts across fields: {lens}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.length = next(iter(lens.values()))
        self.cursor = 0

    @property
    def remaining(self) -> Optional[int]:
        return self.length - self.cursor

    def take(self, n: int) -> Optional[Batch]:
        if self.cursor >= self.length:
            return None
        end = min(self.cursor + n, self.length)
        out = {k: v[self.cursor:end] for k, v in self.arrays.items()}
        self.cursor = end
        return out


StreamLike = Union[StreamSource, Batch]


def as_stream_source(obj: StreamLike) -> StreamSource:
    """Sources pass through, dicts of arrays wrap."""
    if isinstance(obj, StreamSource):
        return obj
    if isinstance(obj, dict):
        return ArrayStreamSource(obj)
    raise TypeError(
        f"cannot interpret {type(obj).__name__} as a stream: pass a StreamSource "
        "or a dict of (R, b, ...) arrays"
    )


class SegmentFeeder:
    """Pulls the trainer's segments from a source, one at a time, and
    accounts for what that costs: the largest segment held and the time
    spent waiting on the source."""

    def __init__(self, source: StreamSource):
        self.source = source
        self.peak_buffered_rounds = 0
        self.take_wait_s = 0.0

    def take(self, n: int) -> Optional[Batch]:
        t0 = time.perf_counter()
        rows = self.source.take(n)
        self.take_wait_s += time.perf_counter() - t0
        if rows is not None:
            got = next(iter(rows.values())).shape[0]
            self.peak_buffered_rounds = max(self.peak_buffered_rounds, got)
        return rows
