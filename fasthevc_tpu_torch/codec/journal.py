"""GOP journal: failure detection + checkpoint/resume (SURVEY.md §5.3/5.4).

The reference (batch CLI) has none; here closed-GOP (IDR) boundaries are
natural checkpoints: the journal records (poc, byte offset) per picture,
and resume restarts encoding at the last complete IDR boundary, producing
a stream byte-identical to an uninterrupted run (asserted in tests via the
fault-injection path).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass


@dataclass
class JournalEntry:
    poc: int
    is_idr: bool
    offset: int      # byte offset of this picture's first NAL in the stream
    size: int


class GopJournal:
    def __init__(self, path: str) -> None:
        self.path = path
        self.entries: list[JournalEntry] = []

    @classmethod
    def load(cls, path: str) -> "GopJournal":
        j = cls(path)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        j.entries.append(JournalEntry(**json.loads(line)))
        return j

    def append(self, entry: JournalEntry) -> None:
        self.entries.append(entry)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry.__dict__) + "\n")

    def last_resume_point(self):
        """(frame_index, byte_offset) of the last complete IDR boundary:
        encoding may resume at that picture with the stream truncated to
        its offset."""
        for e in reversed(self.entries):
            if e.is_idr:
                return e.poc, e.offset
        return 0, None


def encode_journaled(encoder, frames, stream_path: str,
                     journal_path: str) -> bytes:
    """Encode with journaling + resume.

    If stream/journal files exist from an interrupted run, resume at the
    last complete IDR boundary; otherwise encode from scratch. Returns the
    complete stream bytes (also written to stream_path).
    """
    journal = GopJournal.load(journal_path)
    start_frame = 0
    prefix = b""
    if journal.entries and os.path.exists(stream_path):
        poc, offset = journal.last_resume_point()
        with open(stream_path, "rb") as f:
            data = f.read()
        if offset is not None and offset <= len(data):
            prefix = data[:offset]
            start_frame = poc
            # drop journal entries at/after the resume point
            journal.entries = [e for e in journal.entries if e.poc < poc]
            with open(journal_path, "w") as f:
                for e in journal.entries:
                    f.write(json.dumps(e.__dict__) + "\n")

    out = bytearray(prefix)
    fh = open(stream_path, "wb")
    fh.write(prefix)

    def on_frame(poc, is_idr, nal_bytes):
        if poc >= 0:  # poc -1 carries the parameter-set headers
            journal.append(JournalEntry(poc=poc, is_idr=is_idr,
                                        offset=len(out),
                                        size=len(nal_bytes)))
        out.extend(nal_bytes)
        fh.write(nal_bytes)
        fh.flush()

    stream, _ = encoder.encode(frames[start_frame:], start_poc=start_frame,
                               write_headers=(start_frame == 0),
                               on_frame=on_frame)
    fh.close()
    return bytes(out)
