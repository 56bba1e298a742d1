"""Checkpoint / resume for long sharded search sweeps.

The reference has no checkpointing (all calls are short-lived, SURVEY.md
§5); this framework adds it for multi-hour 100MB-scale haystack sweeps:
a sweep over haystack chunks periodically persists (next chunk offset,
matches found so far) so a preempted job resumes instead of restarting.
Plain .npz on purpose — the state is tiny and orbax would be a heavyweight
dependency for two arrays (it stays available for users who want async
checkpointing of bigger state).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..types import Match

__all__ = ["SweepCheckpoint"]


@dataclass
class SweepCheckpoint:
    """Resumable cursor for a chunked haystack sweep.

    `offset` is the first haystack position not yet fully processed;
    `matches` are the Match results accumulated so far.
    """

    path: str
    offset: int = 0
    matches: List[Match] = field(default_factory=list)
    curr_k: Optional[int] = None

    @classmethod
    def load_or_create(cls, path: str) -> "SweepCheckpoint":
        if os.path.exists(path):
            data = np.load(path)
            ms = [
                Match(start=int(s), end=int(e), k=int(kk))
                for s, e, kk in zip(data["start"], data["end"], data["k"])
            ]
            curr_k = int(data["curr_k"][0]) if data["curr_k"][0] >= 0 else None
            return cls(path=path, offset=int(data["offset"][0]),
                       matches=ms, curr_k=curr_k)
        return cls(path=path)

    def save(self) -> None:
        """Atomic write (tmp file + rename) so a crash never corrupts it."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        os.close(fd)
        np.savez(
            tmp,
            offset=np.array([self.offset], dtype=np.int64),
            start=np.array([m.start for m in self.matches], dtype=np.int64),
            end=np.array([m.end for m in self.matches], dtype=np.int64),
            k=np.array([m.k for m in self.matches], dtype=np.int64),
            curr_k=np.array(
                [self.curr_k if self.curr_k is not None else -1],
                dtype=np.int64,
            ),
        )
        # np.savez appends .npz to the name it's given
        os.replace(tmp + ".npz", self.path)
        os.unlink(tmp) if os.path.exists(tmp) else None

    def advance(self, new_offset: int, new_matches: List[Match],
                curr_k: Optional[int] = None) -> None:
        self.offset = new_offset
        self.matches.extend(new_matches)
        if curr_k is not None:
            self.curr_k = curr_k
        self.save()
