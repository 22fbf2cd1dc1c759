"""Lambda-domain rate control (R-lambda model).

Reference parity: HM TEncRateCtrl (SURVEY.md E11) — the standard R-lambda
model (lambda = alpha * bpp^beta) with per-picture bit allocation and
post-picture alpha/beta adaptation, reimplemented from the published
formulation (K. Li et al., the model HM adopted).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class RateControlState:
    alpha: float = 6.7542
    beta: float = -1.7860
    bits_spent: int = 0
    frames_coded: int = 0


class RateController:
    """Per-picture QP decision for a fixed target bitrate."""

    QP_MIN, QP_MAX = 10, 49

    def __init__(self, target_bitrate: float, frame_rate: float,
                 width: int, height: int) -> None:
        self.target_bits_total = 0.0
        self.bits_per_frame = target_bitrate / frame_rate
        self.pixels = width * height
        self.st = RateControlState()

    def picture_qp(self, total_frames: int, is_intra: bool = False) -> int:
        """Allocate bits for the next picture and map to QP via lambda."""
        remaining = max(1, total_frames - self.st.frames_coded)
        budget_left = (self.bits_per_frame * total_frames
                       - self.st.bits_spent)
        target = max(budget_left / remaining, self.bits_per_frame * 0.1)
        if is_intra:
            target *= 3.0  # intra pictures get a larger share (HM-style)
        bpp = target / self.pixels
        lam = self.st.alpha * (bpp ** self.st.beta)
        lam = min(max(lam, 0.1), 10000.0)
        qp = round(4.2005 * math.log(lam) + 13.7122)
        self._last = (bpp, lam)
        return int(min(max(qp, self.QP_MIN), self.QP_MAX))

    def update_after_picture(self, actual_bits: int) -> None:
        """Adapt alpha/beta from the realized rate (lambda-domain update)."""
        bpp_target, lam_used = self._last
        bpp_real = max(actual_bits / self.pixels, 1e-6)
        lam_comp = self.st.alpha * (bpp_real ** self.st.beta)
        err = math.log(lam_used) - math.log(max(lam_comp, 1e-6))
        self.st.alpha *= math.exp(0.10 * err)
        self.st.alpha = min(max(self.st.alpha, 0.05), 500.0)
        self.st.beta += 0.05 * err * math.log(bpp_real)
        self.st.beta = min(max(self.st.beta, -3.0), -0.1)
        self.st.bits_spent += actual_bits
        self.st.frames_coded += 1
