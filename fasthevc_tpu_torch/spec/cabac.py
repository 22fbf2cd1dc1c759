"""CABAC binary arithmetic coder (spec 9.3) — NumPy/Python oracle.

Reference parity: HM TLibEncoder/TEncBinCoderCABAC.cpp +
TLibDecoder/TDecBinCoderCABAC.cpp + ContextModel (SURVEY.md C6) —
reimplemented from H.265 spec 9.3.4 (encode) / 9.3.3 (init) / 9.3.4.3 (decode).

Also provides the fractional-bit *estimator* used for RDO (HM's "counter
mode", SURVEY.md E9): same context transitions, no bit output, cost from
tables.FRAC_BITS.
"""

from __future__ import annotations

import numpy as np

from .bitstream import BitReader, BitWriter
from .tables import (
    CTX_INIT,
    FRAC_BITS,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    TRANS_IDX_MPS,
    init_context_state,
)


class ContextSet:
    """All context models for one slice, addressable by (name, idx)."""

    def __init__(self, init_type: int, slice_qp: int) -> None:
        self.state: dict[str, np.ndarray] = {}
        self.mps: dict[str, np.ndarray] = {}
        for name, inits in CTX_INIT.items():
            vals = inits[init_type]
            st = np.zeros(len(vals), dtype=np.int32)
            mp = np.zeros(len(vals), dtype=np.int32)
            for i, iv in enumerate(vals):
                st[i], mp[i] = init_context_state(iv, slice_qp)
            self.state[name] = st
            self.mps[name] = mp

    def copy(self) -> "ContextSet":
        c = object.__new__(ContextSet)
        c.state = {k: v.copy() for k, v in self.state.items()}
        c.mps = {k: v.copy() for k, v in self.mps.items()}
        return c


class CabacEncoder:
    """Binary arithmetic encoder (spec 9.3.4.3, byte-wise renormalization).

    Carry propagation is handled by buffering a pending byte plus a run of
    0xFF bytes, resolved when a non-0xFF lead byte appears (the standard
    byte-oriented realization of the spec's PutBit/bitsOutstanding scheme).
    """

    def __init__(self, writer: BitWriter, ctx: ContextSet) -> None:
        self.w = writer
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF  # sentinel: nothing emitted yet

    def _write_out(self) -> None:
        lead_byte = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead_byte == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead_byte >> 8
            self.w.write_bits((self.buffered_byte + carry) & 0xFF, 8)
            for _ in range(self.num_buffered - 1):
                self.w.write_bits((0xFF + carry) & 0xFF, 8)
            self.num_buffered = 1
            self.buffered_byte = lead_byte & 0xFF
        else:
            self.num_buffered = 1
            self.buffered_byte = lead_byte

    def _test_write_out(self) -> None:
        if self.bits_left < 12:
            self._write_out()

    def encode_bin(self, name: str, idx: int, binval: int) -> None:
        state = int(self.ctx.state[name][idx])
        mps = int(self.ctx.mps[name][idx])
        lps = int(RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if binval != mps:
            num_bits = _RENORM_TABLE[lps >> 3]
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            if state == 0:
                self.ctx.mps[name][idx] = 1 - mps
            self.ctx.state[name][idx] = TRANS_IDX_LPS[state]
            self.bits_left -= num_bits
        else:
            self.ctx.state[name][idx] = TRANS_IDX_MPS[state]
            if self.range >= 256:
                return
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_write_out()

    def encode_bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        self.bits_left -= 1
        self._test_write_out()

    def encode_bypass_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_write_out()

    def finish(self) -> None:
        """Flush after encode_terminate(1) at slice end (spec 9.3.4.3.5)."""
        if (self.low >> (32 - self.bits_left)) != 0:
            self.w.write_bits((self.buffered_byte + 1) & 0xFF, 8)
            for _ in range(self.num_buffered - 1):
                self.w.write_bits(0x00, 8)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.w.write_bits(self.buffered_byte, 8)
            for _ in range(self.num_buffered - 1):
                self.w.write_bits(0xFF, 8)
        self.w.write_bits(self.low >> 8, 24 - self.bits_left)


_RENORM_TABLE = [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]


class CabacDecoder:
    """Binary arithmetic decoder (spec 9.3.4.3.2)."""

    def __init__(self, reader: BitReader, ctx: ContextSet) -> None:
        self.r = reader
        self.ctx = ctx
        self.range = 510
        self.offset = reader.read_bits(9)

    def decode_bin(self, name: str, idx: int) -> int:
        state = int(self.ctx.state[name][idx])
        mps = int(self.ctx.mps[name][idx])
        lps = int(RANGE_TAB_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            # LPS path
            self.offset -= self.range
            self.range = lps
            binval = 1 - mps
            if state == 0:
                self.ctx.mps[name][idx] = 1 - mps
            self.ctx.state[name][idx] = TRANS_IDX_LPS[state]
        else:
            binval = mps
            self.ctx.state[name][idx] = TRANS_IDX_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.r.read_bit()
        return binval

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self.r.read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.r.read_bit()
        return 0


class CabacEstimator:
    """HM counter-mode rate estimator: context-exact, bit-cost in 2^-15 units.

    Shares context state layout with CabacEncoder so RDO decisions track the
    real coder. Used by the spec encoder and mirrored by the vectorized JAX
    estimator in ops/rate.py.
    """

    def __init__(self, ctx: ContextSet) -> None:
        self.ctx = ctx
        self.frac_bits = 0  # accumulated cost, 2^-15 bit units

    def encode_bin(self, name: str, idx: int, binval: int) -> None:
        state = int(self.ctx.state[name][idx])
        mps = int(self.ctx.mps[name][idx])
        is_lps = int(binval != mps)
        self.frac_bits += int(FRAC_BITS[state, is_lps])
        if is_lps:
            if state == 0:
                self.ctx.mps[name][idx] = 1 - mps
            self.ctx.state[name][idx] = TRANS_IDX_LPS[state]
        else:
            self.ctx.state[name][idx] = TRANS_IDX_MPS[state]

    def encode_bypass(self, binval: int) -> None:
        self.frac_bits += 32768

    def encode_bypass_bits(self, value: int, n: int) -> None:
        self.frac_bits += 32768 * n

    def encode_terminate(self, binval: int) -> None:
        self.frac_bits += 32768  # approximation; terminate bins are rare

    @property
    def bits(self) -> float:
        return self.frac_bits / 32768.0
