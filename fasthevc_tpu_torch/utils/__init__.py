"""Utilities: YUV I/O, synthesis, PSNR, BD-rate, picture hashing."""

from .video import (
    bd_rate,
    pad_plane,
    picture_hash,
    picture_md5,
    psnr,
    synthesize_yuv,
    yuv_from_planes,
)

__all__ = ["bd_rate", "pad_plane", "picture_hash", "picture_md5", "psnr",
           "synthesize_yuv", "yuv_from_planes"]
