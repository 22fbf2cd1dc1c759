"""Codec configuration (SURVEY.md §5.6 analog of HM's TAppEncCfg presets)."""

from .config import (EncoderConfig, GopEntry, all_intra, low_delay_p, quality,
                     random_access_gop16, random_access_gop16_layered)

__all__ = ["EncoderConfig", "GopEntry", "all_intra", "low_delay_p", "quality",
           "random_access_gop16", "random_access_gop16_layered"]
