"""Video utilities: synthetic content, PSNR, BD-rate, picture hash.

Reference parity: HM TAppEncTop YUV I/O + TComPicYuvMD5 (SURVEY.md C10) and
the standard piecewise-cubic BD-rate calculation. Test clips are synthesized
because no real sequences/ffmpeg exist in this environment (SURVEY.md §7.3.6).
"""

from __future__ import annotations

import hashlib

import numpy as np


def synthesize_yuv(width: int, height: int, frames: int, seed: int = 0,
                   motion: bool = True) -> list[tuple[np.ndarray, ...]]:
    """Synthesize CTC-like content: moving gradients + texture + edges.

    Returns a list of (y, cb, cr) uint8 planes, 4:2:0.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    # static texture layer (band-limited noise)
    tex = rng.normal(0, 1, (height // 8 + 2, width // 8 + 2))
    tex = np.kron(tex, np.ones((8, 8)))[:height, :width]
    out = []
    for t in range(frames):
        dx = 2.0 * t if motion else 0.0
        dy = 1.0 * t if motion else 0.0
        grad = 96 + 48 * np.sin((xx + dx) * 2 * np.pi / 192.0) \
            + 32 * np.cos((yy + dy) * 2 * np.pi / 128.0)
        edges = 40.0 * (((xx + 2 * dx) // 48 + (yy + dy) // 48) % 2)
        noise = rng.normal(0, 2.0, (height, width))
        y = np.clip(grad + 10 * tex + edges + noise, 0, 255).astype(np.uint8)
        cb = np.clip(128 + 24 * np.sin((xx[::2, ::2] + dx) / 37.0), 0,
                     255).astype(np.uint8)
        cr = np.clip(128 + 24 * np.cos((yy[::2, ::2] + dy) / 29.0), 0,
                     255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def pad_plane(plane: np.ndarray, coded_h: int, coded_w: int) -> np.ndarray:
    """Edge-replicate a plane to coded (CU-aligned) dimensions."""
    h, w = plane.shape
    out = np.empty((coded_h, coded_w), dtype=plane.dtype)
    out[:h, :w] = plane
    if coded_w > w:
        out[:h, w:] = plane[:, w - 1:w]
    if coded_h > h:
        out[h:, :] = out[h - 1:h, :]
    return out


def yuv_from_planes(planes, width: int, height: int):
    """Crop coded-dimension planes back to display size (uint8)."""
    y = np.asarray(planes[0])[:height, :width].astype(np.uint8)
    cb = np.asarray(planes[1])[:height // 2, :width // 2].astype(np.uint8)
    cr = np.asarray(planes[2])[:height // 2, :width // 2].astype(np.uint8)
    return y, cb, cr


def psnr(a: np.ndarray, b: np.ndarray, max_val: int = 255) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val * max_val / mse)


def picture_md5(planes) -> list[bytes]:
    """Per-plane MD5 over raster-order 8-bit samples (Annex D.3.19)."""
    out = []
    for p in planes:
        arr = np.asarray(p).astype(np.uint8)
        out.append(hashlib.md5(arr.tobytes()).digest())
    return out


def picture_crc(planes) -> list[bytes]:
    """Per-plane 16-bit CRC (Annex D.3.19 hash_type 1).

    The spec's bitwise CRC (poly 0x1021, init 0xFFFF fed in at the
    register bottom, 16 augmenting zero bits) equals the table-driven
    CCITT CRC binascii implements, with the init transformed to
    0xFFFF*x^16 mod G = 0x1D0F (verified bit-by-bit in tests)."""
    import binascii
    out = []
    for p in planes:
        arr = np.asarray(p).astype(np.uint8)
        crc = binascii.crc_hqx(arr.tobytes(), 0x1D0F)
        out.append(bytes(((crc >> 8) & 0xFF, crc & 0xFF)))
    return out


def picture_checksum(planes) -> list[bytes]:
    """Per-plane 32-bit checksum (Annex D.3.19 hash_type 2): sum of
    sample bytes XORed with a position mask."""
    out = []
    for p in planes:
        arr = np.asarray(p).astype(np.uint32)
        h, w = arr.shape
        xs = np.arange(w, dtype=np.uint32)
        ys = np.arange(h, dtype=np.uint32)
        mask = ((xs[None, :] & 0xFF) ^ (ys[:, None] & 0xFF)
                ^ (xs[None, :] >> 8) ^ (ys[:, None] >> 8))
        s = int(((arr & 0xFF) ^ mask).sum(dtype=np.uint64) & 0xFFFFFFFF)
        out.append(s.to_bytes(4, "big"))
    return out


HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2
_HASH_FN = {HASH_MD5: picture_md5, HASH_CRC: picture_crc,
            HASH_CHECKSUM: picture_checksum}
HASH_LEN = {HASH_MD5: 16, HASH_CRC: 2, HASH_CHECKSUM: 4}


def picture_hash(planes, hash_type: int = HASH_MD5) -> list[bytes]:
    """Per-plane decoded-picture hash of the requested Annex D type."""
    return _HASH_FN[hash_type](planes)


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """Bjontegaard delta rate (%) via piecewise-cubic interpolation over
    four (rate, PSNR) points per curve. Negative = test saves bitrate."""
    ra = np.log(np.asarray(rate_anchor, dtype=np.float64))
    rt = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)
    p_min = max(pa.min(), pt.min())
    p_max = min(pa.max(), pt.max())
    if p_max <= p_min:
        return float("nan")
    fa = np.polynomial.polynomial.Polynomial.fit(pa, ra, 3)
    ft = np.polynomial.polynomial.Polynomial.fit(pt, rt, 3)
    xs = np.linspace(p_min, p_max, 100)
    int_a = np.trapezoid(fa(xs), xs)
    int_t = np.trapezoid(ft(xs), xs)
    avg_diff = (int_t - int_a) / (p_max - p_min)
    return float((np.exp(avg_diff) - 1.0) * 100.0)
