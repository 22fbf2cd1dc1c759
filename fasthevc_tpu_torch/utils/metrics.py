"""Structured observability: per-picture JSONL records (SURVEY.md §5.5).

Reference parity: HM's per-picture stdout lines + summary
(TEncGOP::printOutSummary) — upgraded to machine-readable JSONL with
per-stage timings and model-skip rates (the key E8 observability signal).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field


@dataclass
class PictureRecord:
    poc: int
    slice_type: str
    qp: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float
    times: dict = field(default_factory=dict)   # stage -> seconds
    model_skip_rate: float = 0.0  # fraction of CUs pruned by the fast model


class MetricsLog:
    def __init__(self, path: str | None = None) -> None:
        self.path = path
        self.records: list[PictureRecord] = []
        self._fh = open(path, "w") if path else None

    def add(self, rec: PictureRecord) -> None:
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(asdict(rec)) + "\n")
            self._fh.flush()

    def summary(self) -> dict:
        n = max(1, len(self.records))
        return {
            "frames": len(self.records),
            "bits_total": sum(r.bits for r in self.records),
            "psnr_y_avg": sum(r.psnr_y for r in self.records) / n,
            "psnr_u_avg": sum(r.psnr_u for r in self.records) / n,
            "psnr_v_avg": sum(r.psnr_v for r in self.records) / n,
        }

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class StageTimer:
    """Wall-time per named stage (jax work fenced by the caller)."""

    def __init__(self) -> None:
        self.times: dict[str, float] = {}
        self._t0 = None
        self._stage = None

    def start(self, stage: str) -> None:
        self.stop()
        self._stage = stage
        self._t0 = time.time()

    def stop(self) -> None:
        if self._stage is not None:
            self.times[self._stage] = (self.times.get(self._stage, 0.0)
                                       + time.time() - self._t0)
            self._stage = None
