"""Bitstream read/write: RBSP bits, Exp-Golomb, NAL units, emulation prevention.

Reference parity: HM TLibCommon/TComBitStream.cpp + TLibEncoder/NALwrite.cpp
+ TLibDecoder/NALread.cpp (SURVEY.md C7) — reimplemented from H.265 spec 7.3/7.4
and Annex B.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP byte string."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def write_bit(self, bit: int) -> None:
        self._cur = (self._cur << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def write_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (spec 9.2)."""
        assert value >= 0
        code = value + 1
        n = code.bit_length()
        self.write_bits(0, n - 1)
        self.write_bits(code, n)

    def write_se(self, value: int) -> None:
        """Signed Exp-Golomb."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_flag(self, flag: int) -> None:
        self.write_bit(1 if flag else 0)

    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def byte_align(self) -> None:
        """rbsp_trailing_bits: stop bit then zero-pad to byte boundary."""
        self.write_bit(1)
        while self._nbits != 0:
            self.write_bit(0)

    def append_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "append_bytes requires byte alignment"
        self._bytes.extend(data)

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "bitstream not byte aligned"
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read_bit(self) -> int:
        byte = self._data[self._pos >> 3]
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_ue(self) -> int:
        zeros = 0
        while self.read_bit() == 0:
            zeros += 1
        return (1 << zeros) - 1 + (self.read_bits(zeros) if zeros else 0)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if k % 2 == 1 else -(k // 2)

    def read_flag(self) -> int:
        return self.read_bit()

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def read_byte_alignment(self) -> None:
        """Consume byte_alignment(): a 1 bit then zero bits to the boundary
        (spec 7.3.2.10) — always at least one bit, unlike byte_align()."""
        bit = self.read_bit()
        assert bit == 1, "alignment_bit_equal_to_one missing"
        self.byte_align()

    @property
    def bit_position(self) -> int:
        return self._pos

    def more_rbsp_data(self) -> bool:
        """True if there is payload left before rbsp_trailing_bits."""
        total = len(self._data) * 8
        if self._pos >= total:
            return False
        # Find the last 1 bit in the stream (the rbsp stop bit).
        for p in range(total - 1, -1, -1):
            byte = self._data[p >> 3]
            if (byte >> (7 - (p & 7))) & 1:
                return self._pos < p
        return False


# ---------------------------------------------------------------------------
# NAL units (spec 7.3.1.1, 7.4.2 + Annex B)
# ---------------------------------------------------------------------------

# NAL unit types used here.
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


_EP_RE = None


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (0x000003) — spec 7.4.2.

    Regex form of the scalar scan (00 00 followed by a byte <= 03 gets an
    03 inserted; re.sub resumes after the two zeros, which matches the
    zero-counter reset of the byte-wise algorithm). ~100x faster than the
    Python per-byte loop on slice-sized payloads."""
    global _EP_RE
    if _EP_RE is None:
        import re
        _EP_RE = re.compile(b"\x00\x00(?=[\x00-\x03])")
    return _EP_RE.sub(b"\x00\x00\x03", rbsp)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation-prevention bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(ebsp):
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < len(ebsp) and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def write_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0,
              layer_id: int = 0) -> bytes:
    """Wrap RBSP into an Annex-B NAL unit with 4-byte start code."""
    header = bytes([
        (nal_type & 0x3F) << 1 | (layer_id >> 5),
        ((layer_id & 0x1F) << 3) | ((temporal_id + 1) & 7),
    ])
    return b"\x00\x00\x00\x01" + header + rbsp_to_ebsp(rbsp)


def split_annexb(stream: bytes):
    """Iterate (nal_type, temporal_id, rbsp_bytes) over an Annex-B stream."""
    i = 0
    n = len(stream)
    starts = []
    while i < n - 2:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trim trailing zero bytes belonging to the next start code prefix
        while e > s and stream[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        payload = stream[s:e]
        if len(payload) < 2:
            continue
        nal_type = payload[0] >> 1
        temporal_id = (payload[1] & 7) - 1
        yield nal_type, temporal_id, ebsp_to_rbsp(payload[2:])
