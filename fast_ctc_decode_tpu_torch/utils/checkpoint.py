"""Checkpoint/resume for long batched decode runs.

The reference has no checkpointing (decodes are single short calls); a
pipeline streaming millions of reads needs resumable iteration.  The
format is the same as ``fast_ctc_decode_tpu.utils.checkpoint``'s, so a run
checkpointed by one package resumes in the other.  The on-disk format is append-only JSONL so checkpoint cost is
O(batch) per batch (not O(total) — rewriting the whole result set after
every batch would make checkpointing quadratic and eventually dominate
decode time):

    {"meta": {...}}                               # header line
    {"i": [7, 8, 9], "r": [[seq, path, err], …]}  # one line per batch

The ``meta`` header must match for a run to resume, key for key, except
the engine's name: engines whose stored results are the same form one class
(``ENGINE_CLASSES``), so a run resumes under any name of its class.  That
is what lets a JAX-written checkpoint resume here: the JAX package calls its
kernel "pallas" where the port says "cuda", writes None for an automatic
CRF engine where the port writes the engine it chose, and names its duplex
tree kernel "exact-pallas".

Each batch line records explicit read *indices*, so out-of-order
processing (length-bucketed decode) resumes exactly.  Lines are flushed +
fsynced per batch; a crash mid-write leaves at most one truncated trailing
line, which ``load_or_create`` drops.

Used by ``parallel.pipeline.decode_many``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Result = Tuple[str, List[int], int]

#: Engine names whose checkpointed results are the same, by kind of stream.
#: "beam" (1D and CRF, which store (sequence, path, err)): the JAX kernel
#: "pallas", the port's kernel "cuda" and both packages' "fast" are bit-
#: identical, and a missing engine or None is auto, the hash engine on both
#: sides; "exact" records a prefix's first creation time in the path, the
#: hash engines its latest, so it stands alone.  "duplex" (which stores
#: (sequence, err)): the tree kernel "exact-pallas" and the tree engine
#: "exact" are one class; the slot engines "pallas", "cuda" and "fast" are
#: another, for a stream whose windows are all constant ("duplex"), where
#: they agree; on moving windows they diverge, and each stands alone
#: ("duplex_moving").  None (auto) is its own class in both.
ENGINE_CLASSES = {
    "beam": (frozenset({"pallas", "cuda", "fast", None}), frozenset({"exact"})),
    "duplex": (frozenset({"exact-pallas", "exact"}), frozenset({"pallas", "cuda", "fast"}),
               frozenset({None})),
    "duplex_moving": (frozenset({"exact-pallas", "exact"}), frozenset({None})),
}


def same_run(written: Dict, meta: Dict, kind: str) -> bool:
    """True when a checkpoint written with ``written`` may resume under
    ``meta``: every key equal, the engine within one class of
    ``ENGINE_CLASSES[kind]``."""
    a, b = dict(written), dict(meta)
    ea, eb = a.pop("engine", None), b.pop("engine", None)
    return a == b and (ea == eb or any(ea in c and eb in c for c in ENGINE_CLASSES[kind]))


@dataclass
class DecodeCheckpoint:
    """Append-only (index -> result) log for a resumable decode run."""

    path: Optional[str]
    meta: Dict = field(default_factory=dict)
    done: Dict[int, Result] = field(default_factory=dict)
    _fh: object = None

    @classmethod
    def load_or_create(cls, path: Optional[str], meta: Dict, kind: str):
        """Resume from ``path`` when it exists (validating ``meta`` with
        ``same_run(..., kind)`` — resuming with different decode params is
        an error), else start."""
        ckpt = cls(path=path, meta=meta)
        if path is not None and os.path.exists(path):
            with open(path) as f:
                lines = f.read().splitlines()
            if lines:
                header = json.loads(lines[0])
                if not same_run(header.get("meta", {}), meta, kind):
                    raise ValueError(
                        f"checkpoint {path} was written with different decode "
                        f"parameters: {header.get('meta')} != {meta}"
                    )
                ckpt.meta = header.get("meta", meta)
                for line in lines[1:]:
                    try:
                        d = json.loads(line)
                    except json.JSONDecodeError:
                        # truncated line from a crash mid-append; later
                        # lines (written after the newline repair in
                        # _open) are still valid, so keep scanning
                        continue
                    for i, r in zip(d["i"], d["r"]):
                        ckpt.done[int(i)] = (r[0], list(r[1]), int(r[2]))
        return ckpt

    @property
    def cursor(self) -> int:
        """Number of reads already decoded."""
        return len(self.done)

    def _open(self):
        if self._fh is None and self.path is not None:
            dirname = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(dirname, exist_ok=True)
            fresh = not os.path.exists(self.path)
            if not fresh and os.path.getsize(self.path) > 0:
                # a crash can leave a truncated trailing line without a
                # newline; appending directly would merge the next record
                # into it, corrupting BOTH lines for future loads
                with open(self.path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    needs_newline = f.read(1) != b"\n"
            else:
                needs_newline = False
            self._fh = open(self.path, "a")
            if needs_newline:
                self._fh.write("\n")
            if fresh or os.path.getsize(self.path) == 0:
                self._fh.write(json.dumps({"meta": self.meta}) + "\n")
                self._fh.flush()
        return self._fh

    def record(self, indices: Sequence[int], batch_results: Sequence[Result]):
        """Record one decoded batch (appends ONE line: O(batch) I/O)."""
        indices = [int(i) for i in indices]
        batch_results = [tuple(r) for r in batch_results]
        for i, r in zip(indices, batch_results):
            self.done[i] = r
        fh = self._open()
        if fh is not None:
            fh.write(json.dumps({"i": indices, "r": batch_results}) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def results_in_order(self, n: int) -> List[Result]:
        """The first ``n`` results by read index (raises if any is missing)."""
        return [self.done[i] for i in range(n)]

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
