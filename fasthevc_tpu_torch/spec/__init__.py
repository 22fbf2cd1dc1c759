"""Spec-exact golden model (NumPy) — the oracle layer.

Reference parity: this layer covers what HM's TLibCommon/TLibEncoder/
TLibDecoder C++ implements (SURVEY.md §2 components C1-C10, E*, D*), but as
a from-scratch implementation of ITU-T H.265 written directly from the
standard. It is intentionally slow and simple: every TPU kernel in
fasthevc_tpu.ops is unit-tested against this layer, and the encoder it
drives defines the in-repo quality anchor (BASELINE.md).
"""
