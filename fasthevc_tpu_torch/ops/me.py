"""Batched motion estimation and exact motion compensation.

Counterpart of fasthevc_tpu/ops/me.py.  Four kernels carry it on the card:
  * K9 (csrc/me_int.cu), the integer stage, three launches a picture:
    `downsample4` (the 4x decimation of the coarse search), `me_coarse`
    (every tier's full search at a zero centre, the larger tiers' SADs as
    sums of their tier-16 children's) and `me_fine` (every +-3
    refinement, the 16-blocks' SADs as sums of their 8-children's).  The
    earlier form, `sad_search` (one search a launch, counted as
    `me_full_search` or `me_refine`), stays callable; no route launches
    it;
  * K10 (csrc/subpel.cu), the sub-pel stage (`_subpel_core`): 9 half-pel
    then 8 quarter-pel candidates with the exact 8-tap filter, each costed
    SATD + lambda_sqrt * mv-rate;
  * K11 (csrc/mc.cu), exact MC: `mc_merge`, the merge candidates of one
    block size for one or both lists, their MC, SATD and fold in one
    launch (the searches' `with_merge_cands`); `mc_sel`, the earlier form
    (the raw 14-bit prediction and the window test,
    `mc_raw_from_state_sel`; no route launches it); and the commit's
    prediction planes (`inter_pred_planes`: luma 8-tap, chroma 4-tap,
    uni/bi rounding), all three components in one separable launch a
    batch (`fhv_inter_planes`: a thread a window row in registers, the
    horizontal pass in shared memory; counted as
    `inter_pred_fused`, or `inter_pred_fused_bi` when list 1 is given).
    The earlier form, a launch a component (`inter_pred_planes_by_comp`,
    counted as `inter_pred` / `inter_pred_bi`), stays callable; no route
    launches it;
  * K12 (csrc/bi.cu), `bi_select`: the B search's BI candidate, the bi
    average of both lists' exact predictions and its SATD cost, on K11's
    filter (csrc/mc_common.cuh), and the direction chosen from it and the
    lists' costs, with the chosen prediction and rate.  The earlier form,
    `bi_cost` (the candidate alone), stays callable; no route launches
    it.
Each has a plain PyTorch twin (`*_plain`) in this module.  The twins of
`me_coarse`, `me_fine` and `mc_merge` compute as the reference does, one
tier or one candidate at a time, so the card tests hold the kernels' sums
against a computation that does not use them.

The JAX package gathers per-tier reference windows once (edge-clamped, at
a +-80 overhang) and serves every consumer from them through one-hot
selects (me.py:103-184): TPU workarounds.  The windows hold edge-clamped
reference samples, so the port reads the edge-clamped reference directly;
only the `valid` rule of `_mc_raw_windows` (me.py:642-645), which prices
merge candidates that stray outside the window, is kept.

Parity: every integer output is exact, and ties keep the first candidate
in the reference's order.  The sub-pel cost is XLA's: `4 + 2 log2(1 + m)`
comes from `XLA_MV_RATE` (XLA's CPU log2 differs from torch's in the last
ulp for many of the magnitudes the search reaches), and XLA contracts
`satd + lambda_sqrt * rate` into one fused multiply-add.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..spec.mc import CHROMA_FILTERS, LUMA_FILTERS
from . import cost

# Tier sizes of the shared windows and their widths n + 2*3 + 8
# (me.py:147): the `valid` rule of the merge candidates' MC reads them.
TIER_W = {16: 30, 32: 46, 64: 78}
MAX_SEARCH_RANGE = 64  # the reference's windows cover +-64 (me.py:100)

# XLA's f32 values of 4 + 2 * log2(1 + m) for quarter-pel magnitudes
# m = |mvx| + |mvy| in 0 .. 2 * (4 * 64 + 3), as the jitted
# fasthevc_tpu/codec/search.py _mv_rate_bits (and the same expression in
# ops/me.py _subpel_core) computes them on the CPU; little-endian f32
# bytes.  tests/test_torch_me.py holds the table against the jitted JAX
# function.
_XLA_MV_RATE_HEX = (
    "000080400000c0400770e540000000413c4d0a4103b81241dad519410000204107702541"
    "3c4d2a41aab32e4103b83241006a3641dad539413f053d41000040417fcc424107704541"
    "05ef47413c4d4a41dd8d4c41aab34e4105c1504103b85241789a5441006a56410a285841"
    "dad5594194745b413f055d41c6885e4100006041ad6b61417fcc62411623644107706541"
    "d7b3664105ef6741032269413c4d6a4111716b41dd8d6c41f6a36d41aab36e4143bd6f41"
    "05c1704131bf714103b87241b4ab7341789a744182847541006a76411f4b77410a287841"
    "e6007941d9d5794109a77a4194747b419d3e7c413f057d4199c87d41c6887e41e0457f41"
    "000080419f5b8041d7b58041b40e81413f66814184bc81418b1182415d65824103b88241"
    "86098341ec5983413ea9834183f78341c24484410291844149dc84419e26854107708541"
    "88b8854129008641ee468641dd8c8641fbd186414c168741d55987419b9c8741a1de8741"
    "ed1f88418260884165a0884199df8841211e8941025c89413e998941dad58941d8118a41"
    "3c4d8a4109888a4141c28a41e8fb8a4100358b418c6d8b4190a58b410cdd8b4105148c41"
    "7c4a8c4173808c41eeb58c41edea8c41741f8d4184538d4121878d414aba8d4104ed8d41"
    "4e1f8e412c518e41a0828e41aab38e414ce48e418a148f4163448f41da738f41f0a28f41"
    "a7d18f4100009041fc2d90419f5b9041e7889041d7b590416fe29041b40e9141a33a9141"
    "3f6691418a91914184bc91412fe791418b1192419a3b92415d659241d58e924103b89241"
    "e8e0924186099341dc319341ec599341b78193413ea9934181d0934183f79341431e9441"
    "c2449441016b944102919441c4b6944149dc9441920195419e2695416f4b954107709541"
    "6494954188b8954175dc954129009641a7239641ee469641006a9641dd8c964186af9641"
    "fbd196413df496414c16974129389741d5599741507b97419b9c9741b5bd9741a1de9741"
    "5eff9741ed1f98414e409841826098418a80984165a0984114c0984199df9841f2fe9841"
    "211e9941263d9941025c9941b47a99413e999941a0b79941dad59941ecf39941d8119a41"
    "9d2f9a413c4d9a41b56a9a4108889a4137a59a4141c29a4126df9a41e8fb9a4186189b41"
    "00359b4158519b418c6d9b419f899b4190a59b415fc19b410cdd9b4199f89b4105149c41"
    "502f9c417c4a9c4187659c4173809c41409b9c41eeb59c417cd09c41edea9c413f059d41"
    "741f9d418b399d4184539d41616d9d4121879d41c3a09d414aba9d41b5d39d4104ed9d41"
    "37069e414e1f9e414b389e412c519e41f3699e41a0829e41329b9e41aab39e4108cc9e41"
    "4ce49e4178fc9e418a149f41832c9f4163449f412b5c9f41da739f41718b9f41f0a29f41"
    "57ba9f41a7d19f41dfe89f410000a0410a17a041fc2da041d944a0419f5ba0414d72a041"
    "e788a041699fa041d7b5a0412ecca0416fe2a0419cf8a041b40ea141b524a141a33aa141"
    "7c50a1413f66a141ef7ba1418a91a14111a7a14184bca141e4d1a1412fe7a14166fca141"
    "8b11a2419c26a2419a3ba2418550a2415d65a241227aa241d58ea24175a3a24103b8a241"
    "7fcca241e8e0a24140f5a2418609a341b91da341dc31a341ec45a341ec59a341da6da341"
    "b781a3418395a3413ea9a341e8bca34181d0a3410ae4a34183f7a341eb0aa441431ea441"
    "8a31a441c244a441e957a441016ba441097ea4410291a441eba3a441c4b6a4418ec9a441"
    "49dca441f5eea4419201a5411f14a5419e26a5410e39a5416f4ba541c25da5410770a541"
    "3d82a5416494a5417da6a54188b8a54185caa54175dca54156eea5412900a641ef11a641"
    "a723a6415235a641ee46a6417e58a641006aa641767ba641dd8ca641389ea64186afa641"
    "c7c0a641fbd1a64122e3a6413df4a6414a05a7414c16a7414127a7412938a7410549a741"
    "d559a741986aa741507ba741fc8ba7419b9ca7412eada741b6bda74131cea741a1dea741"
    "05efa7415effa741ac0fa841ed1fa8412430a8414e40a8416e50a8418260a8418c70a841"
    "8a80a8417d90a84165a0a84142b0a84114c0a841dccfa84199dfa8414befa841f2fea841"
    "8f0ea941211ea941a92da941263da941994ca941025ca941606ba941b47aa941fe89a941"
    "3e99a94174a8a941a0b7a941c2c6a941dad5a941e8e4a941ecf3a941e702aa41d811aa41"
    "bf20aa419d2faa41713eaa413c4daa41fd5baa41b56aaa416479aa410888aa41a596aa41"
    "37a5aa41c1b3aa4141c2aa41b8d0aa4126dfaa418cedaa41e8fbaa413b0aab418618ab41"
    "c726ab410035ab413043ab415851ab41765fab418c6dab419a7bab419f89ab419c97ab41"
    "90a5ab417cb3ab415fc1ab413acfab410cddab41d6eaab4199f8ab415306ac410514ac41"
    "af21ac41512fac41ea3cac417c4aac410558ac418765ac410173ac417380ac41dd8dac41"
    "409bac419aa8ac41eeb5ac4139c3ac417cd0ac41b8ddac41edeaac411af8ac413f05ad41"
    "5d12ad41741fad41832cad418b39ad418b46ad418453ad417660ad41616dad41447aad41"
    "2187ad41f693ad41c3a0ad418badad414abaad4103c7ad41b5d3ad4160e0ad4104edad41"
    "a0f9ad413706ae41c612ae414e1fae41d02bae414b38ae41bf44ae412c51ae41935dae41"
    "f369ae414d76ae41a082ae41ec8eae41329bae4171a7ae41aab3ae41dcbfae4108ccae41"
    "2dd8ae414ce4ae4165f0ae4178fcae418408af418a14af418920af41832caf417638af41"
    "6344af414a50af412b5caf410568af41da73af41a97faf41718baf413497af41f0a2af41"
    "a7aeaf4157baaf4102c6af41a7d1af4146ddaf41dfe8af4172f4af410000b041880bb041"
    "0a17b0418622b041fc2db0416e39b041d944b0413e50b041")
XLA_MV_RATE = np.frombuffer(bytes.fromhex("".join(_XLA_MV_RATE_HEX)),
                            dtype="<f4").astype(np.float32)
MV_RATE_MAX = XLA_MV_RATE.shape[0] - 1

_CONST: dict = {}


def _const(name: str, device) -> torch.Tensor:
    """The rate table and the filter taps on `device`, cached."""
    key = (name, str(device))
    if key not in _CONST:
        arr = {"rate": XLA_MV_RATE,
               "luma": np.asarray(LUMA_FILTERS, np.int32),
               "chroma": np.asarray(CHROMA_FILTERS, np.int32)}[name]
        _CONST[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return _CONST[key]


def mv_rate_bits(mv: torch.Tensor) -> torch.Tensor:
    """The MVD rate proxy of [..., 2] quarter-pel MVs, f32 bits: XLA's
    4 + 2 log2(1 + |mvx| + |mvy|) (search.py:48 `_mv_rate_bits`).  The
    magnitudes stay inside the table by construction: the search range
    is at most 64 and a sub-pel step adds at most 3 per component."""
    mag = mv[..., 0].abs() + mv[..., 1].abs()
    return _const("rate", mv.device)[mag.long()]


# ---------------------------------------------------------------------------
# Plain helpers shared by the twins
# ---------------------------------------------------------------------------

def _block_origins(h: int, w: int, n: int, device):
    """Row and column origins [B] of the aligned n-blocks, raster order."""
    gy, gx = h // n, w // n
    oy = (torch.arange(gy, device=device) * n).repeat_interleave(gx)
    ox = (torch.arange(gx, device=device) * n).repeat(gy)
    return oy, ox


def _windows(planes: torch.Tensor, sel, oy, ox, size_h: int,
             size_w: int) -> torch.Tensor:
    """[B, size_h, size_w] edge-clamped windows of planes[sel[b]] ([N, H,
    W]) whose top-left corners are (oy[b], ox[b]), possibly outside."""
    _, h, w = planes.shape
    dev = planes.device
    rows = (oy[:, None] + torch.arange(size_h, device=dev)).clamp(0, h - 1)
    cols = (ox[:, None] + torch.arange(size_w, device=dev)).clamp(0, w - 1)
    # one flat gather: cheaper than indexing the three dimensions
    flat = ((sel[:, None] * h + rows) * w)[:, :, None] + cols[:, None, :]
    return planes.reshape(-1)[flat]


def _blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """[H, W] -> [H/n * W/n, n, n], raster order."""
    h, w = plane.shape
    return (plane.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3)
            .reshape(-1, n, n))


def _mc_raw_plain(planes, sel, oy, ox, mv, n: int, taps: torch.Tensor,
                  frac_bits: int, bit_depth: int = 8) -> torch.Tensor:
    """The spec's 14-bit intermediate prediction (8.5.4.2.2) of n x n
    blocks at (oy, ox) of planes[sel] for per-block MVs mv [B, 2] (x, y)
    in 1/2^frac_bits units: the separable two-stage filter on the
    edge-clamped reference (the zero-phase row reproduces the copy and
    one-direction cases exactly).  int64 [B, n, n]."""
    n_taps = taps.shape[1]
    half = n_taps // 2 - 1
    mvi = mv >> frac_bits
    frac = mv & ((1 << frac_bits) - 1)
    # int32 is exact: a tap row's absolute sum is at most 112, so a
    # 12-bit sample's first stage stays below 2^19 and the second (after
    # the shift to 14 bits) below 2^22
    fx = taps[frac[:, 0]].to(torch.int32)
    fy = taps[frac[:, 1]].to(torch.int32)
    size = n + n_taps - 1
    win = _windows(planes, sel, oy + mvi[:, 1] - half, ox + mvi[:, 0] - half,
                   size, size).to(torch.int32)
    hacc = sum(fx[:, k, None, None] * win[:, :, k:k + n]
               for k in range(n_taps))
    hacc = hacc >> (bit_depth - 8)
    acc = sum(fy[:, k, None, None] * hacc[:, k:k + n, :]
              for k in range(n_taps))
    return (acc >> 6).to(torch.int64)


# ---------------------------------------------------------------------------
# K9: the integer stage
# ---------------------------------------------------------------------------

def downsample4_plain(planes: torch.Tensor) -> torch.Tensor:
    """K9 twin: [N, H, W] -> [N, H/4, W/4], (sum of each 4x4 + 8) >> 4
    (me.py:129)."""
    nn_, h, w = planes.shape
    s = planes.to(torch.int32).reshape(nn_, h // 4, 4, w // 4, 4).sum(
        dim=(2, 4), dtype=torch.int32)
    return (s + 8) >> 4


def downsample4(planes: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """4x decimation of [N, H, W] int32 planes (H, W multiples of 4).
    CUDA tensors go through K9 unless `plain`."""
    if plain or not planes.is_cuda:
        return downsample4_plain(planes)
    planes = planes.to(torch.int32).contiguous()
    _build.require_cuda("downsample4", planes, dtype=torch.int32)
    nn_, h, w = planes.shape
    out = torch.empty((nn_, h // 4, w // 4), dtype=torch.int32,
                      device=planes.device)
    rc = _build.lib().fhv_downsample4(planes.data_ptr(), out.data_ptr(), nn_,
                                      h, w, _build.stream_handle(planes))
    _build.launched("me_downsample4")
    _build.check(rc, "me_downsample4")
    return out


def _centres(center, refs, n: int, base_n: int, device):
    """Per (ref, n-block) centre [R, B, 2]: zero, or the base of the
    block's base_n-parent."""
    r, h, w = refs.shape
    oy, ox = _block_origins(h, w, n, device)
    if center is None:
        return torch.zeros((r, oy.shape[0], 2), dtype=torch.int64,
                           device=device)
    parent = (oy // base_n) * (w // base_n) + ox // base_n
    return center.to(torch.int64)[:, parent]


def sad_search_plain(src, refs, center, n: int, rng: int, base_n: int,
                     scale: int, clip: int) -> torch.Tensor:
    """K9 twin: for every (ref, n-block), the SAD-best integer offset d in
    [-rng, rng]^2 around the block's centre (zero, or center [R, Bc, 2] of
    its base_n-parent), visited dy-major with strict < (the first minimum
    wins, as the reference's scan and argmin keep it), on the edge-clamped
    reference.  Returns clip((centre + d) * scale) [R, B, 2] int32 (x, y):
    `_full_search_int` with centre 0, the tier refinement of `me_state`
    (me.py:266-306) with the tier base."""
    dev = refs.device
    r, h, w = refs.shape
    oy, ox = _block_origins(h, w, n, dev)
    b = oy.shape[0]
    c = _centres(center, refs, n, base_n, dev)                # [R, B, 2]
    srcb = _blocks(src.to(torch.int32), n).repeat(r, 1, 1)    # [R*B, n, n]
    sel = torch.arange(r, device=dev).repeat_interleave(b)
    size = n + 2 * rng
    win = _windows(refs, sel, (oy[None] + c[..., 1] - rng).reshape(-1),
                   (ox[None] + c[..., 0] - rng).reshape(-1), size,
                   size).to(torch.int32)
    n_off = 2 * rng + 1
    best = torch.full((r * b,), 2 ** 31 - 1, dtype=torch.int64, device=dev)
    best_i = torch.zeros((r * b,), dtype=torch.int64, device=dev)
    for dy in range(n_off):
        # every dx of the row at once: [R*B, n rows, n_off, n cols]; min
        # keeps the first of equal SADs, as the scan's strict < does
        cand = win[:, dy:dy + n].unfold(2, n, 1)
        sad = (cand - srcb[:, :, None]).abs().sum(dim=(1, 3))
        row_best, dx = sad.min(dim=1)
        better = row_best < best
        best = torch.where(better, row_best, best)
        best_i = torch.where(better, dy * n_off + dx, best_i)
    d = torch.stack([best_i % n_off - rng, best_i // n_off - rng], dim=-1)
    out = (c.reshape(-1, 2) + d) * scale
    return out.clamp(-clip, clip).reshape(r, b, 2).to(torch.int32)


def sad_search(src, refs, center, n: int, rng: int, base_n: int, scale: int,
               clip: int, plain: bool = False) -> torch.Tensor:
    """The integer SAD search of `sad_search_plain`: src [H, W] and refs
    [R, H, W] int32.  CUDA tensors go through K9 unless `plain`."""
    if plain or not src.is_cuda:
        return sad_search_plain(src, refs, center, n, rng, base_n, scale,
                                clip)
    src = src.to(torch.int32).contiguous()
    refs = refs.to(torch.int32).contiguous()
    tensors = [src, refs]
    if center is not None:
        center = center.to(torch.int32).contiguous()
        tensors.append(center)
    _build.require_cuda("sad_search", *tensors, dtype=torch.int32)
    r, h, w = refs.shape
    if src.shape != (h, w) or h % n or w % n:
        raise ValueError("sad_search: src [H, W], refs [R, H, W], H and W "
                         "multiples of n")
    if (n + 2 * rng) ** 2 * 4 + n * n * 4 > 48 * 1024:
        raise ValueError("sad_search: window too large for the kernel")
    b = (h // n) * (w // n)
    out = torch.empty((r, b, 2), dtype=torch.int32, device=src.device)
    name = "me_full_search" if center is None else "me_refine"
    rc = _build.lib().fhv_sad_search(
        src.data_ptr(), refs.data_ptr(),
        None if center is None else center.data_ptr(), out.data_ptr(), r, h,
        w, n, rng, base_n, scale, clip, _build.stream_handle(src))
    _build.launched(name)
    _build.check(rc, name)
    return out


def me_coarse_plain(src, refs, search_range: int, tiers, scale: int
                    ) -> dict:
    """K9 twin, coarse stage (me.py:233-248): each tier's full search at a
    zero centre over [-rng, rng]^2 on the search planes src [H, W] and refs
    [R, H, W] (the 1/4 planes at scale 4, rng = ceil(SR / 4); full
    resolution at scale 1, rng = SR), one tier at a time.  Returns {tier:
    [R, B_tier, 2] int32} = clip(d * scale, -SR, SR)."""
    rng = search_range if scale == 1 else -(-search_range // 4)
    return {n: sad_search_plain(src, refs, None, n // scale, rng,
                                n // scale, scale, search_range)
            for n in tiers}


def _tier_list(tiers) -> list:
    tiers = list(tiers)
    if tiers != [16, 32, 64][:len(tiers)] or not tiers:
        raise ValueError(f"K9: tiers {tiers} must be 16, 32[, 64]")
    return tiers


def me_coarse(src, refs, search_range: int, tiers, scale: int,
              plain: bool = False) -> dict:
    """The coarse stage of `me_coarse_plain` in one launch: CUDA tensors go
    through K9 unless `plain`.  The planes' sides must be multiples of the
    largest tier's block on them.  The kernel keeps samples as 16 bits in
    shared memory, which holds any HEVC sample (bit depths up to 16)."""
    if plain or not src.is_cuda:
        return me_coarse_plain(src, refs, search_range, tiers, scale)
    tiers = _tier_list(tiers)
    src = src.to(torch.int32).contiguous()
    refs = refs.to(torch.int32).contiguous()
    _build.require_cuda("me_coarse", src, refs, dtype=torch.int32)
    r, h, w = refs.shape
    c, k = 16 // scale, tiers[-1] // 16
    rng = search_range if scale == 1 else -(-search_range // 4)
    ts = c * k
    if (scale not in (1, 4) or src.shape != (h, w) or h % ts or w % ts
            or 2 * (ts * ts + (ts + 2 * rng) ** 2) > 48 * 1024):
        raise ValueError("me_coarse: src [H, W] and refs [R, H, W] with "
                         "sides multiples of the largest tier on them, "
                         "scale 1 or 4, the window within 48 KB")
    out = {n: torch.empty((r, (h * scale // n) * (w * scale // n), 2),
                          dtype=torch.int32, device=src.device)
           for n in tiers}
    rc = _build.lib().fhv_me_coarse(
        src.data_ptr(), refs.data_ptr(), out[16].data_ptr(),
        out[32].data_ptr() if 32 in out else None,
        out[64].data_ptr() if 64 in out else None, r, h, w, c, k, rng,
        scale, search_range, _build.stream_handle(src))
    _build.launched("me_coarse")
    _build.check(rc, "me_coarse")
    return out


def me_fine_plain(y, refs, base: dict, search_range: int, tiers) -> dict:
    """K9 twin, refinement stage (me.py:265-306): each tier's +-3
    refinement around its base, then the 8-blocks' around their
    16-parent's base, one at a time.  y [H, W], refs [R, H, W], base
    {tier: [R, B_tier, 2]}.  Returns {n: [R, B_n, 2] int32} for the tiers,
    then 8: clip(base + d, -SR, SR)."""
    mv = {n: sad_search_plain(y, refs, base[n], n, 3, n, 1, search_range)
          for n in tiers}
    mv[8] = sad_search_plain(y, refs, base[16], 8, 3, 16, 1, search_range)
    return mv


def me_fine(y, refs, base: dict, search_range: int, tiers,
            plain: bool = False) -> dict:
    """The refinements of `me_fine_plain` in one launch: CUDA tensors go
    through K9 unless `plain`.  H and W must be multiples of the largest
    tier."""
    if plain or not y.is_cuda:
        return me_fine_plain(y, refs, base, search_range, tiers)
    tiers = _tier_list(tiers)
    y = y.to(torch.int32).contiguous()
    refs = refs.to(torch.int32).contiguous()
    bases = {n: base[n].to(torch.int32).contiguous() for n in tiers}
    _build.require_cuda("me_fine", y, refs, *bases.values(),
                        dtype=torch.int32)
    r, h, w = refs.shape
    t = tiers[-1]
    if y.shape != (h, w) or h % t or w % t or any(
            b.shape != (r, (h // n) * (w // n), 2) for n, b in bases.items()):
        raise ValueError("me_fine: y [H, W], refs [R, H, W] with H, W "
                         "multiples of the largest tier, base {tier: [R, "
                         "B_tier, 2]}")
    out = {n: torch.empty((r, (h // n) * (w // n), 2), dtype=torch.int32,
                          device=y.device) for n in tiers + [8]}

    def ptr(d, n):
        return d[n].data_ptr() if n in d else None

    rc = _build.lib().fhv_me_fine(
        y.data_ptr(), refs.data_ptr(), ptr(bases, 16), ptr(bases, 32),
        ptr(bases, 64), ptr(out, 8), ptr(out, 16), ptr(out, 32),
        ptr(out, 64), r, h, w, t, search_range, _build.stream_handle(y))
    _build.launched("me_fine")
    _build.check(rc, "me_fine")
    return out


class MEState:
    """Integer ME state of one source frame against R reference planes
    (me.py:187): base {tier: [R, B, 2]} coarse bases and mv_int {n: [R,
    B, 2]} refined integer MVs, both in integer pels (x, y)."""

    def __init__(self, y_plane, refs, search_range: int):
        self.h, self.w = y_plane.shape
        self.R = refs.shape[0]
        self.sr = search_range
        self.y = y_plane
        self.refs = refs
        self.base: dict = {}
        self.mv_int: dict = {}
        self.tiers: list = []


def me_state(y_plane, ref_planes, search_range: int, max_size: int = 32,
             plain: bool = False, decimated=None) -> MEState:
    """Coarse bases per tier (`me_coarse`), then the +-3 refinement of
    every tier around its base and of the 8-blocks around their 16-parent's
    base (`me_fine`) (me.py:220): K9 in three launches (two when SR <= 8
    or `decimated` is given).
    y_plane [H, W]; ref_planes [R, H, W] or a list of [H, W].  decimated:
    the 4x4-decimated [source, refs...] [1 + R, H/4, W/4] to search above
    SR 8 in place of decimating y_plane and the refs here (a tile shard's,
    halo-exchanged after decimation, so that the picture's bounds clamp
    the coarse windows as the whole picture's do)."""
    if search_range > MAX_SEARCH_RANGE:
        raise ValueError(f"search_range {search_range} > "
                         f"{MAX_SEARCH_RANGE}: the reference's windows end "
                         "there")
    y = y_plane.to(torch.int32).contiguous()
    refs = (torch.stack(list(ref_planes)) if isinstance(ref_planes,
                                                        (list, tuple))
            else ref_planes).to(torch.int32).contiguous()
    st = MEState(y, refs, search_range)
    st.tiers = [n for n in (16, 32, 64) if n <= max_size]
    sr = search_range
    if sr <= 8:
        st.base = me_coarse(y, refs, sr, st.tiers, 1, plain=plain)
    else:
        ds = (downsample4(torch.cat([y[None], refs]), plain=plain)
              if decimated is None else decimated.to(torch.int32))
        st.base = me_coarse(ds[0], ds[1:], sr, st.tiers, 4, plain=plain)
    st.mv_int = me_fine(y, refs, st.base, sr, st.tiers, plain=plain)
    return st


# ---------------------------------------------------------------------------
# K10: the sub-pel stage
# ---------------------------------------------------------------------------

_HALF = [(dx, dy) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
_QUARTER = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if dx or dy]


def subpel_plain(src, refs, mv_int, n: int, lambda_sqrt: float):
    """K10 twin (me.py:343 `_subpel_core` for every (ref, n-block)): the 9
    half-pel candidates around 4 * mv_int (dy outer, dx inner, the centre
    included), then the 8 quarter-pel ones around the stage-1 winner, each
    filtered exactly and costed fma(lambda_sqrt, XLA_MV_RATE[|mvq|],
    SATD) in f32; strict < from (inf, 4 * mv_int, 0).  Returns (cost [R,
    B] f32, mvq [R, B, 2] int32, pred [R, B, n, n] int32)."""
    dev = refs.device
    r, h, w = refs.shape
    oy, ox = _block_origins(h, w, n, dev)
    b = oy.shape[0]
    sel = torch.arange(r, device=dev).repeat_interleave(b)
    oyr, oxr = oy.repeat(r), ox.repeat(r)
    srcr = _blocks(src.to(torch.int32), n).repeat(r, 1, 1)
    mvi4 = mv_int.reshape(-1, 2).to(torch.int64) * 4
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    taps = _const("luma", dev)

    def stage(offsets):
        """The first cheapest of K candidates a block, offsets [K, R*B or
        1, 2]: all K filtered and costed in one batch; min keeps the first
        of equal costs, as the scan's strict < does."""
        k = offsets.shape[0]
        mvq = (mvi4 + offsets).reshape(-1, 2)                 # [K*R*B, 2]
        raw = _mc_raw_plain(refs, sel.repeat(k), oyr.repeat(k),
                            oxr.repeat(k), mvq, n, taps, 2)
        pred = ((raw + 32) >> 6).clamp(0, 255).to(torch.int32)
        s = cost.satd_plain(srcr.repeat(k, 1, 1), pred[:, None])[:, 0]
        c = cost.fma_f32(ls, mv_rate_bits(mvq), s.to(torch.float32))
        c, i = c.view(k, -1).min(dim=0)
        pick = torch.arange(c.shape[0], device=dev)
        return (c, mvq.view(k, -1, 2)[i, pick],
                pred.view(k, -1, n, n)[i, pick])

    # the costs are finite, so the half-pel scan's first candidate always
    # replaces the (inf, 4 * mv_int, 0) start
    best_c, best_mv, best_p = stage(torch.tensor(_HALF, device=dev)[:, None])
    q_c, q_mv, q_p = stage((best_mv - mvi4)[None]
                           + torch.tensor(_QUARTER, device=dev)[:, None])
    better = q_c < best_c
    best_c = torch.where(better, q_c, best_c)
    best_mv = torch.where(better[:, None], q_mv, best_mv)
    best_p = torch.where(better[:, None, None], q_p, best_p)
    return (best_c.reshape(r, b), best_mv.to(torch.int32).reshape(r, b, 2),
            best_p.reshape(r, b, n, n))


def subpel(src, refs, mv_int, n: int, lambda_sqrt: float,
           plain: bool = False):
    """Sub-pel refinement of `subpel_plain`: src [H, W], refs [R, H, W],
    mv_int [R, B, 2] int32.  CUDA tensors go through K10 unless `plain`."""
    if plain or not src.is_cuda:
        return subpel_plain(src, refs, mv_int, n, lambda_sqrt)
    src = src.to(torch.int32).contiguous()
    refs = refs.to(torch.int32).contiguous()
    mv_int = mv_int.to(torch.int32).contiguous()
    _build.require_cuda("subpel", src, refs, mv_int, dtype=torch.int32)
    r, h, w = refs.shape
    b = (h // n) * (w // n)
    if src.shape != (h, w) or mv_int.shape != (r, b, 2) or n not in (8, 16,
                                                                     32, 64):
        raise ValueError("subpel: src [H, W], refs [R, H, W], mv_int "
                         "[R, B, 2], n in 8..64")
    dev = src.device
    tab = _const("rate", dev)
    out_c = torch.empty((r, b), dtype=torch.float32, device=dev)
    out_mv = torch.empty((r, b, 2), dtype=torch.int32, device=dev)
    out_p = torch.empty((r, b, n, n), dtype=torch.int32, device=dev)
    ls = float(torch.tensor(lambda_sqrt, dtype=torch.float32))
    rc = _build.lib().fhv_subpel(
        src.data_ptr(), refs.data_ptr(), mv_int.data_ptr(), tab.data_ptr(),
        tab.shape[0], ls, out_c.data_ptr(), out_mv.data_ptr(),
        out_p.data_ptr(), r, h, w, n, _build.stream_handle(src))
    _build.launched("subpel")
    _build.check(rc, "subpel")
    return out_c, out_mv, out_p


def subpel_from_state(st: MEState, lambda_sqrt: float,
                      plain: bool = False) -> dict:
    """{n: (cost [R, B], mvq [R, B, 2], pred [R, B, n, n])} for every
    tier and the 8-blocks (me.py:564)."""
    return {n: subpel(st.y, st.refs, st.mv_int[n], n, lambda_sqrt,
                      plain=plain)
            for n in st.tiers + [8]}


# ---------------------------------------------------------------------------
# K11: exact MC
# ---------------------------------------------------------------------------

def mc_sel_plain(refs, base, mvq, sel, n: int, tier: int):
    """K11 twin, merge-candidate form (me.py:630-685): the raw 14-bit luma
    prediction of every n-block of refs[sel[b]] ([R, H, W]) for per-block
    quarter-pel mvq [B, 2], and `valid` [B]: the integer MV lies inside
    the reference's window around the block's tier base (base [R, Bt, 2]
    of the tier grid; the 8-blocks ride the 16-tier).  Returns (raw [B,
    n, n] int32, valid [B] bool)."""
    dev = refs.device
    _, h, w = refs.shape
    oy, ox = _block_origins(h, w, n, dev)
    sel = sel.to(torch.int64)
    parent = (oy // tier) * (w // tier) + ox // tier
    bs = base.to(torch.int64)[sel, parent]
    mvq = mvq.to(torch.int64)
    mvi = mvq >> 2
    rs = mvi[:, 1] - bs[:, 1] + oy % tier + 4
    cs = mvi[:, 0] - bs[:, 0] + ox % tier + 4
    lim = TIER_W[tier] - (n + 7)
    valid = (rs >= 0) & (rs <= lim) & (cs >= 0) & (cs <= lim)
    raw = _mc_raw_plain(refs, sel, oy, ox, mvq, n, _const("luma", dev), 2)
    return raw.to(torch.int32), valid


def mc_sel(refs, base, mvq, sel, n: int, tier: int, plain: bool = False):
    """The merge-candidate MC of `mc_sel_plain`.  CUDA tensors go through
    K11 unless `plain`."""
    if plain or not refs.is_cuda:
        return mc_sel_plain(refs, base, mvq, sel, n, tier)
    refs = refs.to(torch.int32).contiguous()
    base = base.to(torch.int32).contiguous()
    mvq = mvq.to(torch.int32).contiguous()
    sel = sel.to(torch.int32).contiguous()
    _build.require_cuda("mc_sel", refs, base, mvq, sel, dtype=torch.int32)
    r, h, w = refs.shape
    b = (h // n) * (w // n)
    if mvq.shape != (b, 2) or sel.shape != (b,) or tier not in TIER_W:
        raise ValueError("mc_sel: mvq [B, 2], sel [B], tier 16/32/64")
    raw = torch.empty((b, n, n), dtype=torch.int32, device=refs.device)
    valid = torch.empty((b,), dtype=torch.int32, device=refs.device)
    rc = _build.lib().fhv_mc_sel(
        refs.data_ptr(), base.data_ptr(), mvq.data_ptr(), sel.data_ptr(),
        raw.data_ptr(), valid.data_ptr(), r, h, w, n, tier, TIER_W[tier],
        _build.stream_handle(refs))
    _build.launched("mc_sel")
    _build.check(rc, "mc_sel")
    return raw, valid.bool()


def mc_raw_from_state_sel(st: MEState, r_lo: int, r_hi: int, sel, n: int,
                          mvq, plain: bool = False):
    """Raw MC of every n-block with a per-block choice between refs r_lo
    and r_hi (sel [B] bool, True -> r_hi), and the window test against
    the chosen ref's base (me.py:671): (raw [B, n, n], valid [B])."""
    refsel = torch.where(sel.bool(), r_hi, r_lo)
    tier = 16 if n == 8 else n
    return mc_sel(st.refs, st.base[tier], mvq, refsel, n, tier, plain=plain)


def neighbor_fields(field: torch.Tensor, gy: int, gx: int,
                    edge_col: int = -1) -> tuple:
    """The left and top same-size-grid neighbours of a [B, C] block field
    (zero at the frame edge): the searches' stand-ins for the merge
    candidates A1/B1 (fasthevc_tpu/codec/search.py:54 `_neighbor_mvs`).
    edge_col >= 0: the grid column whose left neighbour is the picture's
    edge inside a halo-extended shard, where the left field is zero too
    (:61-75)."""
    c = field.shape[-1]
    m = field.reshape(gy, gx, c)
    left = torch.cat([torch.zeros_like(m[:, :1]), m[:, :-1]], dim=1)
    if edge_col >= 0:
        left[:, edge_col] = 0
    top = torch.cat([torch.zeros_like(m[:1]), m[:-1]], dim=0)
    return left.reshape(-1, c), top.reshape(-1, c)


def mc_merge_plain(st: MEState, lists, n: int, lambda_sqrt: float,
                   edge_col: int = -1, mc=mc_sel_plain,
                   satd=cost.satd_plain) -> list:
    """K11 twin, merge form: the merge fold as the reference composes it
    (search.py:438 `with_merge_cands`; the P search's loop at :318-334 is
    the same), one candidate at a time on `mc` (mc_sel's signature) and
    `satd` (K2's), their twins by default (`mc_sel` and `cost.satd` give
    the earlier form's path on the card):
    for each list (ia, ib, mv [B, 2], ridx [B], pred [B, n, n], cost [B],
    rate_bits [B]) of ME winners, the left and then the top same-size
    neighbour's (MV, ref) is predicted from state ref ia (ref 0) or ib,
    priced SATD + 2 lambda_sqrt in f32 (inf where `valid` fails) and taken
    by strict <; a winner adopts the neighbour's ref and 2 rate bits.
    Returns [(mv, ridx, pred, cost, rate_bits)] per list."""
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    src_b = _blocks(st.y.to(torch.int32), n)
    tier = 16 if n == 8 else n
    out = []
    for ia, ib, mv, ridx, pred, cost_, rate_bits in lists:
        field = torch.cat([mv, ridx[:, None]], dim=1)
        for cand in neighbor_fields(field, st.h // n, st.w // n, edge_col):
            cmv, cref = cand[:, :2].contiguous(), cand[:, 2]
            raw_c, valid = mc(st.refs, st.base[tier], cmv,
                              torch.where(cref > 0, ib, ia), n, tier)
            predc = ((raw_c + 32) >> 6).clamp(0, 255)
            costc = torch.where(
                valid, satd(src_b, predc[:, None])[:, 0].to(torch.float32)
                + ls * 2.0, float("inf"))
            better = costc < cost_
            cost_ = torch.where(better, costc, cost_)
            mv = torch.where(better[:, None], cmv, mv)
            ridx = torch.where(better, cref, ridx)
            pred = torch.where(better[:, None, None], predc, pred)
            rate_bits = torch.where(better, 2.0, rate_bits)
        out.append((mv, ridx, pred, cost_, rate_bits))
    return out


def mc_merge(st: MEState, lists, n: int, lambda_sqrt: float,
             edge_col: int = -1, plain: bool = False) -> list:
    """The merge fold of `mc_merge_plain` for one or two lists in one
    launch: CUDA tensors go through K11 unless `plain`.  Returns [(mv [B,
    2] int32, ridx [B] int32, pred [B, n, n] int32, cost [B] f32,
    rate_bits [B] f32)] per list."""
    if plain or not st.y.is_cuda:
        return mc_merge_plain(st, lists, n, lambda_sqrt, edge_col)
    if not 1 <= len(lists) <= 2 or n not in (8, 16, 32, 64):
        raise ValueError("mc_merge: one or two lists, n in 8..64")
    tier = 16 if n == 8 else n
    y = st.y.to(torch.int32).contiguous()
    refs = st.refs.to(torch.int32).contiguous()
    base = st.base[tier].to(torch.int32).contiguous()
    h, w = y.shape
    b = (h // n) * (w // n)
    ins, pairs = [], []
    for ia, ib, mv, ridx, pred, cost_, rate_bits in lists:
        i32 = [t.to(torch.int32).contiguous() for t in (mv, ridx, pred)]
        f32 = [t.to(torch.float32).contiguous() for t in (cost_, rate_bits)]
        if (i32[0].shape != (b, 2) or i32[1].shape != (b,)
                or i32[2].shape != (b, n, n)
                or any(t.shape != (b,) for t in f32)):
            raise ValueError("mc_merge: mv [B, 2], ridx [B], pred [B, n, "
                             "n], cost and rate [B] per list")
        ins.append(i32 + f32)
        pairs += [int(ia), int(ib)]
    _build.require_cuda("mc_merge", y, refs, base, *(t for li in ins
                                                      for t in li[:3]),
                        dtype=torch.int32)
    _build.require_cuda("mc_merge", *(t for li in ins for t in li[3:]),
                        dtype=torch.float32)
    if h % tier or w % tier or base.shape != (refs.shape[0], (h // tier)
                                              * (w // tier), 2):
        raise ValueError("mc_merge: H, W multiples of the tier, base [R, "
                         "Bt, 2]")
    nl, dev = len(lists), y.device
    out = [torch.empty((nl, b, 2), dtype=torch.int32, device=dev),
           torch.empty((nl, b), dtype=torch.int32, device=dev),
           torch.empty((nl, b, n, n), dtype=torch.int32, device=dev),
           torch.empty((nl, b), dtype=torch.float32, device=dev),
           torch.empty((nl, b), dtype=torch.float32, device=dev)]
    l1 = ins[1] if nl > 1 else [None] * 5
    pairs += [0, 0] * (2 - nl)
    ls2 = float(np.float32(lambda_sqrt) * np.float32(2.0))
    rc = _build.lib().fhv_mc_merge(
        y.data_ptr(), refs.data_ptr(), base.data_ptr(),
        *(t.data_ptr() for t in ins[0]),
        *(None if t is None else t.data_ptr() for t in l1),
        *(t.data_ptr() for t in out), nl, *pairs, h, w, n, tier,
        TIER_W[tier], edge_col, ls2, _build.stream_handle(y))
    _build.launched("mc_merge")
    _build.check(rc, "mc_merge")
    return [tuple(t[i] for t in out) for i in range(nl)]


# ---------------------------------------------------------------------------
# K12: the bi-prediction cost of the B search
# ---------------------------------------------------------------------------

def bi_cost_plain(src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits,
                  lambda_sqrt: float, n: int):
    """K12 twin (search.py:476-481): the raw predictions of both lists
    at each list's final MV and absolute ref index (the filter of
    mc_sel_plain; the window test is not taken: every such MV passed it),
    their bi average pbi = clip((raw0 + raw1 + 64) >> 7, 0, 255) and its
    cost fma(lambda_sqrt, r0bits + r1bits, SATD(src - pbi)) in f32.  src
    [H, W], refs [R, H, W], mv0/mv1 [B, 2] quarter pels, sel0/sel1 [B],
    r0bits/r1bits [B] f32.  Returns (pbi [B, n, n] int32, cbi [B] f32)."""
    h, w = src.shape
    oy, ox = _block_origins(h, w, n, refs.device)
    taps = _const("luma", refs.device)
    raw0, raw1 = (_mc_raw_plain(refs, sel.to(torch.int64), oy, ox,
                                mv.to(torch.int64), n, taps, 2)
                  for mv, sel in ((mv0, sel0), (mv1, sel1)))
    pbi = ((raw0 + raw1 + 64) >> 7).clamp(0, 255).to(torch.int32)
    s = cost.satd_plain(_blocks(src.to(torch.int32), n), pbi[:, None])[:, 0]
    ls = torch.tensor(lambda_sqrt, dtype=torch.float32)
    return pbi, cost.fma_f32(ls, r0bits + r1bits, s.to(torch.float32))


def bi_cost(src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits,
            lambda_sqrt: float, n: int, plain: bool = False):
    """The BI candidate of `bi_cost_plain`.  CUDA tensors go through K12
    unless `plain`."""
    if plain or not src.is_cuda:
        return bi_cost_plain(src, refs, mv0, sel0, mv1, sel1, r0bits,
                             r1bits, lambda_sqrt, n)
    i32 = [t.to(torch.int32).contiguous()
           for t in (src, refs, mv0, sel0, mv1, sel1)]
    f32 = [t.to(torch.float32).contiguous() for t in (r0bits, r1bits)]
    src, refs, mv0, sel0, mv1, sel1 = i32
    _build.require_cuda("bi_cost", *i32, *f32)
    r, h, w = refs.shape
    b = (h // n) * (w // n)
    if (src.shape != (h, w) or n not in (8, 16, 32, 64) or h % n or w % n
            or mv0.shape != (b, 2) or mv1.shape != (b, 2)
            or sel0.shape != (b,) or sel1.shape != (b,)
            or any(t.shape != (b,) for t in f32)):
        raise ValueError("bi_cost: src [H, W], refs [R, H, W], mv0/mv1 "
                         "[B, 2], sel0/sel1/r0bits/r1bits [B], n in 8..64")
    pbi = torch.empty((b, n, n), dtype=torch.int32, device=src.device)
    cbi = torch.empty((b,), dtype=torch.float32, device=src.device)
    ls = float(torch.tensor(lambda_sqrt, dtype=torch.float32))
    rc = _build.lib().fhv_bi_cost(
        src.data_ptr(), refs.data_ptr(), mv0.data_ptr(), sel0.data_ptr(),
        mv1.data_ptr(), sel1.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
        ls, pbi.data_ptr(), cbi.data_ptr(), r, h, w, n,
        _build.stream_handle(src))
    _build.launched("bi_cost")
    _build.check(rc, "bi_cost")
    return pbi, cbi


def bi_select_plain(src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, c0,
                    c1, p0, p1, lambda_sqrt: float, n: int):
    """K12's selected form's twin (search.py:476-491): bi_cost_plain's
    (pbi, cbi), then the direction as the B search chose it in PyTorch:
    the first least of (c0, c1, cbi) (argmin over the stack, as
    jnp.argmin), and the reference's exact one-hot selects of the
    prediction and the rate.  c0/c1 [B] f32 and p0/p1 [B, n, n] are the
    lists' merge winners.  Returns (pred_sel [B, n, n] int32, rate_sel [B]
    f32, dchoice [B] int32: 0 list 0, 1 list 1, 2 BI)."""
    pbi, cbi = bi_cost_plain(src, refs, mv0, sel0, mv1, sel1, r0bits,
                             r1bits, lambda_sqrt, n)
    dchoice = torch.argmin(torch.stack([c0, c1, cbi]), dim=0)
    d3 = dchoice[:, None, None]
    pred_sel = torch.where(d3 == 0, p0, torch.where(d3 == 1, p1, pbi))
    rate_sel = torch.where(dchoice == 0, r0bits,
                           torch.where(dchoice == 1, r1bits,
                                       r0bits + r1bits))
    return (pred_sel.to(torch.int32), rate_sel,
            dchoice.to(torch.int32))


def bi_select(src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, c0, c1, p0,
              p1, lambda_sqrt: float, n: int, plain: bool = False):
    """The BI candidate and the direction of `bi_select_plain` in one
    launch of K12's selected form: CUDA tensors go through it unless
    `plain`.  pbi reaches device memory only where BI wins, and p0 / p1 are
    read only where their list wins."""
    if plain or not src.is_cuda:
        return bi_select_plain(src, refs, mv0, sel0, mv1, sel1, r0bits,
                               r1bits, c0, c1, p0, p1, lambda_sqrt, n)
    i32 = [t.to(torch.int32).contiguous()
           for t in (src, refs, mv0, sel0, mv1, sel1, p0, p1)]
    f32 = [t.to(torch.float32).contiguous() for t in (r0bits, r1bits, c0,
                                                       c1)]
    src, refs, mv0, sel0, mv1, sel1, p0, p1 = i32
    _build.require_cuda("bi_select", *i32, *f32)
    r, h, w = refs.shape
    b = (h // n) * (w // n)
    if (src.shape != (h, w) or n not in (8, 16, 32, 64) or h % n or w % n
            or mv0.shape != (b, 2) or mv1.shape != (b, 2)
            or sel0.shape != (b,) or sel1.shape != (b,)
            or p0.shape != (b, n, n) or p1.shape != (b, n, n)
            or any(t.shape != (b,) for t in f32)):
        raise ValueError("bi_select: src [H, W], refs [R, H, W], mv0/mv1 "
                         "[B, 2], p0/p1 [B, n, n], sel0/sel1/r0bits/r1bits/"
                         "c0/c1 [B], n in 8..64")
    dev = src.device
    pred_sel = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    rate_sel = torch.empty((b,), dtype=torch.float32, device=dev)
    dchoice = torch.empty((b,), dtype=torch.int32, device=dev)
    ls = float(torch.as_tensor(lambda_sqrt, dtype=torch.float32))
    rc = _build.lib().fhv_bi_select(
        src.data_ptr(), refs.data_ptr(), mv0.data_ptr(), sel0.data_ptr(),
        mv1.data_ptr(), sel1.data_ptr(), *(t.data_ptr() for t in f32),
        p0.data_ptr(), p1.data_ptr(), ls, pred_sel.data_ptr(),
        rate_sel.data_ptr(), dchoice.data_ptr(), r, h, w, n,
        _build.stream_handle(src))
    _build.launched("bi_select")
    _build.check(rc, "bi_select")
    return pred_sel, rate_sel, dchoice


def _as_stack(p: torch.Tensor, frames: bool) -> torch.Tensor:
    """A reference component as [F, R, H, W]."""
    if frames:
        return p if p.dim() == 4 else p[:, None]
    return (p if p.dim() == 3 else p[None])[None]


def _inter_comp_plain(ref0, ref1, d, mv, rmap, chroma: bool,
                      bit_depth: int) -> torch.Tensor:
    """K11 twin, plane form, one component of F frames: ref0/ref1 [F, R,
    H, W] (ref1 None for P), d [F, gh, gw], mv [F, gh, gw, 4], rmap [F,
    gh, gw, 2] or None.  Returns [F, H, W] int32 (me.py:535-556)."""
    dev = ref0.device
    nf, r0, h, w = ref0.shape
    gh, gw = d.shape[1:]
    g = 4 if chroma else 8
    taps = _const("chroma" if chroma else "luma", dev)
    fb = 3 if chroma else 2
    oy, ox = _block_origins(gh * g, gw * g, g, dev)
    f = torch.arange(nf, device=dev).repeat_interleave(gh * gw)
    oy, ox = oy.repeat(nf), ox.repeat(nf)
    mvf = mv.reshape(-1, 4).to(torch.int64)
    rm = (rmap.reshape(-1, 2).to(torch.int64) if rmap is not None
          else torch.zeros((mvf.shape[0], 2), dtype=torch.int64, device=dev))

    def raw(ref, li):
        nr = ref.shape[1]
        s = f * nr + (rm[:, li] if nr > 1 else 0)
        return _mc_raw_plain(ref.reshape(nf * nr, h, w), s, oy, ox,
                             mvf[:, 2 * li:2 * li + 2], g, taps, fb,
                             bit_depth)

    raw0 = raw(ref0, 0)
    raw1 = raw(ref1, 1) if ref1 is not None else raw0
    dd = d.reshape(-1)[:, None, None]
    shift = 14 - bit_depth
    uni = torch.where(dd == 2, raw1, raw0)
    pred = torch.where(dd == 3, (raw0 + raw1 + (1 << shift)) >> (shift + 1),
                       (uni + (1 << (shift - 1))) >> shift)
    pred = pred.clamp(0, (1 << bit_depth) - 1).to(torch.int32)
    return (pred.reshape(nf, gh, gw, g, g).permute(0, 1, 3, 2, 4)
            .reshape(nf, gh * g, gw * g))


def _inter_comp_cuda(ref0, ref1, d, mv, rmap, chroma: bool,
                     bit_depth: int) -> torch.Tensor:
    ref0 = ref0.to(torch.int32).contiguous()
    tensors = [ref0]
    if ref1 is not None:
        ref1 = ref1.to(torch.int32).contiguous()
        tensors.append(ref1)
    d = d.to(torch.int32).contiguous()
    mv = mv.to(torch.int32).contiguous()
    tensors += [d, mv]
    if rmap is not None:
        rmap = rmap.to(torch.int32).contiguous()
        tensors.append(rmap)
    _build.require_cuda("inter_pred", *tensors, dtype=torch.int32)
    nf, r0, h, w = ref0.shape
    gh, gw = d.shape[1:]
    g = 4 if chroma else 8
    if (gh * g, gw * g) != (h, w) or mv.shape != (nf, gh, gw, 4):
        raise ValueError("inter_pred: refs [F, R, H, W] with H, W = 8 (luma)"
                         " or 4 (chroma) samples per granule of the maps")
    out = torch.empty((nf, h, w), dtype=torch.int32, device=ref0.device)
    rc = _build.lib().fhv_inter_pred(
        ref0.data_ptr(), None if ref1 is None else ref1.data_ptr(),
        d.data_ptr(), mv.data_ptr(),
        None if rmap is None else rmap.data_ptr(), out.data_ptr(), nf, r0,
        0 if ref1 is None else ref1.shape[1], h, w, int(chroma), bit_depth,
        _build.stream_handle(ref0))
    # the bi-predicting form of B pictures counts apart from P's
    name = "inter_pred" if ref1 is None else "inter_pred_bi"
    _build.launched(name)
    _build.check(rc, name)
    return out


def _planes_inputs(ref0, ref1, dir_map, mv_map, ref_map):
    """inter_pred_planes' arguments as (frames, [F, R, H, W] stacks of
    each list's three components (ref1's None for P), d, mv, rmap)."""
    frames = dir_map.dim() == 3
    d = dir_map if frames else dir_map[None]
    mv = mv_map if frames else mv_map[None]
    rm = None if ref_map is None else (ref_map if frames else ref_map[None])
    r0 = [_as_stack(ref0[ci], frames) for ci in range(3)]
    r1 = None if ref1 is None else [_as_stack(ref1[ci], frames)
                                    for ci in range(3)]
    return frames, r0, r1, d, mv, rm


def _by_comp(comp, r0, r1, d, mv, rm, bit_depth: int) -> list:
    """The three planes, one `comp` call (twin or kernel) a component."""
    return [comp(r0[ci], None if r1 is None else r1[ci], d, mv, rm, ci > 0,
                 bit_depth) for ci in range(3)]


def _planes_cuda(r0, r1, d, mv, rm, bit_depth: int) -> list:
    """K11's planes form: the three components in one launch."""
    i32 = torch.int32
    r0 = [r.to(i32).contiguous() for r in r0]
    r1 = None if r1 is None else [r.to(i32).contiguous() for r in r1]
    d, mv = d.to(i32).contiguous(), mv.to(i32).contiguous()
    rm = None if rm is None else rm.to(i32).contiguous()
    tensors = r0 + (r1 or []) + [d, mv] + ([] if rm is None else [rm])
    _build.require_cuda("inter_pred", *tensors, dtype=i32)
    nf, nr0, h, w = r0[0].shape
    gh, gw = d.shape[1:]
    nr1 = 0 if r1 is None else r1[0].shape[1]
    want = [(nf, nr0, h, w)] + [(nf, nr0, h // 2, w // 2)] * 2
    if r1 is not None:
        want += [(nf, nr1, h, w)] + [(nf, nr1, h // 2, w // 2)] * 2
    if ((gh * 8, gw * 8) != (h, w) or mv.shape != (nf, gh, gw, 4)
            or [tuple(r.shape) for r in r0 + (r1 or [])] != want
            or (rm is not None and rm.shape != (nf, gh, gw, 2))):
        raise ValueError("inter_pred: refs [F, R, H, W] (chroma [F, R, H/2,"
                         " W/2]) with H, W = 8 luma samples per granule of "
                         "the maps")
    outs = [torch.empty((nf, h >> (c > 0), w >> (c > 0)), dtype=i32,
                        device=d.device) for c in range(3)]
    ptr1 = [None] * 3 if r1 is None else [r.data_ptr() for r in r1]
    rc = _build.lib().fhv_inter_planes(
        *(r.data_ptr() for r in r0), *ptr1, d.data_ptr(), mv.data_ptr(),
        None if rm is None else rm.data_ptr(),
        *(o.data_ptr() for o in outs), nf, nr0, nr1, h, w, bit_depth,
        _build.stream_handle(d))
    # the bi-predicting form of B pictures counts apart from P's
    name = "inter_pred_fused" if r1 is None else "inter_pred_fused_bi"
    _build.launched(name)
    _build.check(rc, name)
    return outs


def inter_pred_planes(ref0, ref1, dir_map, mv_map, bit_depth: int = 8,
                      ref_map=None, plain: bool = False):
    """Exact MC prediction planes for decided per-granule motion
    (me.py:508).  ref0/ref1: (y, cb, cr), each [H, W], [R, H, W] (one
    frame) or [F, R, H, W] (F frames; dir_map then [F, gh, gw]); ref1 None
    for P.  dir_map [(F,) gh, gw] (0 intra, 1 L0, 2 L1, 3 BI), mv_map
    [(F,) gh, gw, 4] quarter-pel, ref_map [(F,) gh, gw, 2] per-list ref
    index into the stacks.  Returns (pred_y, pred_cb, pred_cr) int32;
    intra granules hold the L0 prediction at their (zero) MVs, as in the
    reference.  CUDA tensors go through K11's planes form, one launch for
    the three components, unless `plain`."""
    frames, r0, r1, d, mv, rm = _planes_inputs(ref0, ref1, dir_map, mv_map,
                                               ref_map)
    if plain or not d.is_cuda:
        out = _by_comp(_inter_comp_plain, r0, r1, d, mv, rm, bit_depth)
    else:
        out = _planes_cuda(r0, r1, d, mv, rm, bit_depth)
    return tuple(p if frames else p[0] for p in out)


def inter_pred_planes_by_comp(ref0, ref1, dir_map, mv_map,
                              bit_depth: int = 8, ref_map=None):
    """`inter_pred_planes` through K11's earlier plane form, one launch a
    component (`fhv_inter_pred`); arguments and result as
    `inter_pred_planes`.  CPU tensors run the twin."""
    frames, r0, r1, d, mv, rm = _planes_inputs(ref0, ref1, dir_map, mv_map,
                                               ref_map)
    comp = _inter_comp_cuda if d.is_cuda else _inter_comp_plain
    out = _by_comp(comp, r0, r1, d, mv, rm, bit_depth)
    return tuple(p if frames else p[0] for p in out)
