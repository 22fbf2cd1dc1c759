"""C++ host CABAC engine bindings (ctypes).

Reference parity: the native half of SURVEY.md §2.5 — exact sequential
bitstream emission in C++, bit-identical to the Python oracle coder
(enforced by tests/test_cabac_cpp.py). Python keeps syntax derivation for
tree-level elements (few bins); the dominant residual-coding bins are
serialized entirely in C++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..spec.cabac import ContextSet
from ..spec.tables import CTX_INIT

_DIR = os.path.dirname(os.path.abspath(__file__))
# slice_engine.cpp #includes cabac.cpp -> one compile unit, one library
_SRC = os.path.join(_DIR, "slice_engine.cpp")
_SRC_DEP = os.path.join(_DIR, "cabac.cpp")
# Port copy: the products go to build/fasthevc_tpu_torch/ under the
# checkout root, keyed by a hash of the sources and flags (as _build.py
# keys the CUDA library), never next to the sources.
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "fasthevc_tpu_torch")
_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17",
          "-shared", "-fPIC", "-pthread"]


def _keyed(stem: str, ext: str, flags, *srcs) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}{ext}")


_SO = _keyed("libfasthevc_cabac", ".so", _FLAGS, _SRC, _SRC_DEP)


def _compile(out: str, cmd_tail: list) -> None:
    """g++ into a temporary name, then an atomic rename: concurrent
    processes never load a half-written product."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *cmd_tail, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, out)


# canonical linearization of the context families (dict order of CTX_INIT)
CTX_OFFSETS: dict[str, int] = {}
_off = 0
for _name, _inits in CTX_INIT.items():
    CTX_OFFSETS[_name] = _off
    _off += len(_inits[0])
N_CTX = _off

_lib = None


def build(force: bool = False) -> str:
    """Compile the shared library if needed; returns its path."""
    if force or not os.path.exists(_SO):
        _compile(_SO, [*_FLAGS, f"-I{_DIR}", _SRC])
    return _SO


def build_sanitized(force: bool = False) -> str:
    """Build the ASan+UBSan self-test driver (SURVEY.md §5.2); returns the
    executable path. Run it (subprocess) to fuzz the bin engine, residual
    coder and deblock filter under the sanitizers."""
    main_src = os.path.join(_DIR, "sanitize_main.cpp")
    flags = ["-O1", "-g", "-std=c++17", "-pthread",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
    exe = _keyed("sanitize_main", "", flags, main_src, _SRC, _SRC_DEP)
    if force or not os.path.exists(exe):
        _compile(exe, [*flags, f"-I{_DIR}", main_src, _SRC])
    return exe


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(_SO)
    lib.cabac_enc_new.restype = ctypes.c_void_p
    lib.cabac_enc_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cabac_enc_free.argtypes = [ctypes.c_void_p]
    lib.cabac_enc_bin.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.cabac_enc_bypass.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cabac_enc_bypass_bits.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                          ctypes.c_int]
    lib.cabac_enc_terminate.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cabac_enc_finish.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint32)]
    lib.cabac_enc_finish.restype = ctypes.c_int
    lib.cabac_enc_residual.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int32),
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
    lib.cabac_enc_size.argtypes = [ctypes.c_void_p]
    lib.cabac_enc_size.restype = ctypes.c_int
    lib.cabac_enc_copy.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.hevc_deblock_picture.restype = None
    lib.hevc_deblock_picture.argtypes = [
        i32p, i32p, i32p,                    # rec planes (in place)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w,h,ctu,tu
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bd, qps
        i8p,                                 # depth_map
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # mf (nullable)
        ctypes.c_void_p]                     # tusplit (nullable)
    lib.hevc_entropy_slice_tiled.restype = ctypes.c_int
    lib.hevc_entropy_slice_tiled.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w,h,ctu,bd
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # qps
        ctypes.c_int, ctypes.c_int,          # lossless, bypass_enabled
        i8p, i8p, ctypes.c_int,              # depth_map, mode_map, dm_w
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # slice_type, dir/mv
        i16p, i16p, i16p,                    # levels planes
        u8p, u8p, ctypes.c_int,              # ctx states/mps/n
        i32p,                                # ctx offsets [25]
        ctypes.c_int, ctypes.c_int, i32p, i32p,  # tiles
        ctypes.c_int, ctypes.c_void_p,       # sao_enabled, sao_params
        ctypes.c_int,                        # sdh
        u8p,                                 # payload out
        i32p,                                # per-tile sizes out
        ctypes.c_void_p, ctypes.c_void_p,    # mctx scalars, col_dir
        ctypes.c_void_p, ctypes.c_void_p,    # col_mv, col_refpoc
        ctypes.c_void_p]                     # ref_map
    lib.hevc_encode_slice_tiled.restype = ctypes.c_int
    lib.hevc_encode_slice_tiled.argtypes = [
        u8p, u8p, u8p,                       # src planes
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w,h,ctu,bd
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # qps
        ctypes.c_int, ctypes.c_int,          # lossless, bypass_enabled
        i8p, i8p, ctypes.c_int,              # depth_map, mode_map, dm_w
        u8p, u8p, ctypes.c_int,              # ctx states/mps/n
        i32p,                                # ctx offsets [25]
        ctypes.c_int, ctypes.c_int, i32p, i32p,  # tiles
        ctypes.c_int, ctypes.c_int,          # deblock_enabled, sao_enabled
        ctypes.c_int,                        # quant_flags (rdoq | sdh<<1 | ts<<2)
        ctypes.c_int, i8p, i16p,             # slice_type, dir_map, mv_map
        i32p, i32p, i32p, i32p, i32p, i32p,  # ref planes l0 + l1
        i32p, i32p, u8p, u8p,                # motion field export
        i32p, i32p, i32p,                    # rec planes
        u8p,                                 # payload out
        i32p,                                # per-tile sizes out
        ctypes.c_void_p, ctypes.c_void_p,    # mctx scalars, col_dir
        ctypes.c_void_p, ctypes.c_void_p,    # col_mv, col_refpoc
        ctypes.c_void_p,                     # ref_map
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ref0b y/cb/cr
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ref1b y/cb/cr
        ctypes.c_void_p]                     # weighted-pred table (nullable)
    _lib = lib
    return lib


def _marshal_wp(wp):
    """Marshal spec.wp.WpTables to the C ABI int32[26] layout (see
    SliceEnc::wp in slice_engine.cpp); None -> (None, None)."""
    if wp is None:
        return None, None
    arr = np.zeros(26, dtype=np.int32)
    arr[0] = wp.log2_denom_y
    arr[1] = wp.log2_denom_c
    from ..spec.wp import default_entry
    dflt = default_entry(wp.log2_denom_y, wp.log2_denom_c)
    for li, entries in ((0, wp.l0), (1, wp.l1)):
        for ri in range(2):
            e = entries[ri] if ri < len(entries) else dflt
            off = 2 + (li * 2 + ri) * 6
            arr[off:off + 6] = (e.w_y, e.o_y, e.w_cb, e.o_cb,
                                e.w_cr, e.o_cr)
    return arr.ctypes.data_as(ctypes.c_void_p), arr


_OFFSET_ORDER = [
    "last_sig_coeff_prefix", "coded_sub_block_flag", "sig_coeff_flag",
    "coeff_abs_level_greater1_flag", "coeff_abs_level_greater2_flag",
    "split_cu_flag", "cu_transquant_bypass_flag", "part_mode",
    "prev_intra_luma_pred_flag", "intra_chroma_pred_mode", "cbf_luma",
    "cbf_chroma", "cu_skip_flag", "pred_mode_flag", "merge_flag",
    "merge_idx", "inter_pred_idc", "mvd_flag", "mvp_flag", "rqt_root_cbf",
    "sao_merge_flag", "sao_type_idx", "ref_idx", "transform_skip_flag",
    "split_transform_flag",
]


def _marshal_mctx(mctx, ref_map):
    """Marshal a spec.inter.MotionCtx (+ per-granule ref map) to the C
    ABI: (scalar ptr, col_dir ptr, col_mv ptr, col_refpoc ptr, ref_map
    ptr, keepalive list).  None mctx -> all null (single-ref defaults)."""
    keep = []

    def vp(arr):
        keep.append(arr)
        return arr.ctypes.data_as(ctypes.c_void_p)

    rm_ptr = None
    if ref_map is not None:
        rm_ptr = vp(np.ascontiguousarray(ref_map, dtype=np.int8))
    if mctx is None:
        return None, None, None, None, rm_ptr, keep
    l0 = list(mctx.l0_pocs)[:2]
    l1 = list(mctx.l1_pocs)[:2]
    sc = np.asarray(
        [mctx.cur_poc, max(1, len(l0)),
         l0[0] if l0 else 0, l0[1] if len(l0) > 1 else 0,
         max(1, len(l1)), l1[0] if l1 else 0,
         l1[1] if len(l1) > 1 else 0,
         int(bool(mctx.tmvp)), int(bool(mctx.col_from_l0)),
         int(mctx.col_poc), int(mctx.no_backward)], dtype=np.int32)
    cd = cm = cr = None
    if mctx.col_dir is not None:
        cd = vp(np.ascontiguousarray(mctx.col_dir, dtype=np.int8))
        cm = vp(np.ascontiguousarray(mctx.col_mv, dtype=np.int16))
        cr = vp(np.ascontiguousarray(mctx.col_refpoc, dtype=np.int32))
    return vp(sc), cd, cm, cr, rm_ptr, keep


def encode_slice_native(src_planes, sp, qp_y, qp_cb, qp_cr, depth_map,
                        mode_map, ctx: ContextSet, lossless: bool,
                        slice_type: int = 2, dir_map=None, mv_map=None,
                        refs=((), ()), deblock: bool = False,
                        sao: bool = False, rdoq: bool = False,
                        sdh: bool = False, ts: bool = False,
                        rqt: bool = False, mctx=None, ref_map=None,
                        wp=None):
    """Run the two-phase C++ slice engine: commit, then in-loop filters
    (deblock + SAO when enabled), then entropy — for one decided slice
    (I/P/B), with tiles executed on parallel threads. The returned recon
    is post-filter; SAO parameters are estimated, applied, and coded
    internally (spec 7.3.8.3 CTU syntax).

    src_planes: (y, cb, cr) int arrays in coded dims.
    depth_map/mode_map: int8 [coded_h/8, coded_w/8] decision maps.
    dir_map/mv_map (P/B): int8 [gh,gw] inter dir (0=intra) and int16
    [gh,gw,4] per-granule (mv0x,mv0y,mv1x,mv1y).
    refs: (refs_l0, refs_l1) lists of Planes-like objects.
    Returns (substreams, rec_y, rec_cb, rec_cr, motion) where motion =
    (mf_mv [gh4,gw4,2,2], mf_ref [gh4,gw4,2], mf_cbf, mf_inter) for
    host-side deblock BS derivation. Substreams are byte-aligned tile
    substreams ready to append after the slice header.
    """
    lib = _load()
    w, h = sp.coded_width, sp.coded_height
    sy = np.ascontiguousarray(src_planes[0], dtype=np.uint8)
    scb = np.ascontiguousarray(src_planes[1], dtype=np.uint8)
    scr = np.ascontiguousarray(src_planes[2], dtype=np.uint8)
    states = np.zeros(N_CTX, dtype=np.uint8)
    mps = np.zeros(N_CTX, dtype=np.uint8)
    for name, off in CTX_OFFSETS.items():
        n = len(ctx.state[name])
        states[off:off + n] = ctx.state[name]
        mps[off:off + n] = ctx.mps[name]
    offsets = np.array([CTX_OFFSETS[n] for n in _OFFSET_ORDER], dtype=np.int32)
    rec_y = np.zeros((h, w), dtype=np.int32)
    rec_cb = np.zeros((h // 2, w // 2), dtype=np.int32)
    rec_cr = np.zeros((h // 2, w // 2), dtype=np.int32)
    payload = np.empty(w * h * 3 + 4096, dtype=np.uint8)
    dm = np.ascontiguousarray(depth_map, dtype=np.int8)
    mm = np.ascontiguousarray(mode_map, dtype=np.int8)
    n_tiles = sp.tile_cols * sp.tile_rows
    col_b = np.asarray(sp.tile_col_bounds(), dtype=np.int32)
    row_b = np.asarray(sp.tile_row_bounds(), dtype=np.int32)
    sizes = np.zeros(n_tiles, dtype=np.int32)
    gh8, gw8 = dm.shape
    if dir_map is None:
        dir_map = np.zeros((gh8, gw8), dtype=np.int8)
        mv_map = np.zeros((gh8, gw8, 4), dtype=np.int16)
    dir_map = np.ascontiguousarray(dir_map, dtype=np.int8)
    mv_map = np.ascontiguousarray(mv_map, dtype=np.int16)

    def plane_i32(p):
        return np.ascontiguousarray(p, dtype=np.int32)

    dummy = np.zeros(1, dtype=np.int32)
    r0 = refs[0][0] if refs[0] else None
    r1 = refs[1][0] if refs[1] else None
    r0y = plane_i32(r0.y) if r0 is not None else dummy
    r0cb = plane_i32(r0.cb) if r0 is not None else dummy
    r0cr = plane_i32(r0.cr) if r0 is not None else dummy
    r1y = plane_i32(r1.y) if r1 is not None else r0y
    r1cb = plane_i32(r1.cb) if r1 is not None else r0cb
    r1cr = plane_i32(r1.cr) if r1 is not None else r0cr
    # second active reference per list (multi-ref commit MC)
    keep2 = []

    def second(lst, i):
        if len(lst) <= 1:
            return None, None, None
        a, b, c = (plane_i32(lst[1].y), plane_i32(lst[1].cb),
                   plane_i32(lst[1].cr))
        keep2.extend([a, b, c])
        vp = ctypes.c_void_p
        return (a.ctypes.data_as(vp), b.ctypes.data_as(vp),
                c.ctypes.data_as(vp))

    r0b = second(refs[0], 1)
    r1b = second(refs[1], 1)
    gh4, gw4 = h >> 2, w >> 2
    mf_mv = np.zeros((gh4, gw4, 2, 2), dtype=np.int32)
    mf_ref = np.full((gh4, gw4, 2), -1, dtype=np.int32)
    mf_cbf = np.zeros((gh4, gw4), dtype=np.uint8)
    mf_inter = np.zeros((gh4, gw4), dtype=np.uint8)
    mctx_p, cd_p, cm_p, cr_p, rm_p, _keep = _marshal_mctx(mctx, ref_map)
    wp_p, _wp_keep = _marshal_wp(wp)
    total = lib.hevc_encode_slice_tiled(
        sy, scb, scr, w, h, sp.log2_ctu, sp.bit_depth, qp_y, qp_cb, qp_cr,
        int(lossless), int(sp.transquant_bypass_enabled), dm, mm,
        dm.shape[1], states, mps, N_CTX, offsets,
        sp.tile_cols, sp.tile_rows, col_b, row_b,
        int(deblock), int(sao),
        int(rdoq) | (int(sdh) << 1) | (int(ts) << 2) | (int(rqt) << 3),
        slice_type, dir_map, mv_map, r0y, r0cb, r0cr, r1y, r1cb, r1cr,
        mf_mv, mf_ref, mf_cbf, mf_inter,
        rec_y, rec_cb, rec_cr, payload, sizes,
        mctx_p, cd_p, cm_p, cr_p, rm_p,
        r0b[0], r0b[1], r0b[2], r1b[0], r1b[1], r1b[2], wp_p)
    subs = []
    off = 0
    for t in range(n_tiles):
        subs.append(payload[off:off + int(sizes[t])].tobytes())
        off += int(sizes[t])
    assert off == total
    return (subs, rec_y, rec_cb, rec_cr,
            (mf_mv, mf_ref, mf_cbf, mf_inter))


def entropy_slice_native(sp, qp_y, qp_cb, qp_cr, depth_map, mode_map,
                         lv_y, lv_cb, lv_cr, ctx: ContextSet,
                         sao_params=None, sdh: bool = True,
                         ts: bool = False, rqt: bool = False,
                         lossless: bool = False, slice_type: int = 2,
                         dir_map=None, mv_map=None, mctx=None,
                         ref_map=None):
    """Entropy-only slice emission from device-committed levels (the TPU
    wavefront-commit path, SURVEY.md §2.5): the C++ engine fills its
    decision store from the provided int16 level planes and runs the
    phase-2 CABAC emission per tile on parallel threads.

    sao_params: int32 [sao_ny, sao_nx, 3, 7] from ops.sao.sao_device, or
    None when SAO is off.  For P/B slices pass slice_type (1=P, 0=B) and
    the per-8x8-granule dir_map (int8, 0=intra/1=L0/2=L1/3=BI) + mv_map
    (int16 [gh, gw, 4]); the engine replays the merge/AMVP syntax
    derivation in decode order (store_inter_syntax) from the maps — the
    pixel work already happened on device.  Returns the list of
    byte-aligned tile substreams."""
    lib = _load()
    w, h = sp.coded_width, sp.coded_height
    states = np.zeros(N_CTX, dtype=np.uint8)
    mps = np.zeros(N_CTX, dtype=np.uint8)
    for name, off in CTX_OFFSETS.items():
        n = len(ctx.state[name])
        states[off:off + n] = ctx.state[name]
        mps[off:off + n] = ctx.mps[name]
    offsets = np.array([CTX_OFFSETS[n] for n in _OFFSET_ORDER],
                       dtype=np.int32)
    dm = np.ascontiguousarray(depth_map, dtype=np.int8)
    mm = np.ascontiguousarray(mode_map, dtype=np.int8)
    lv_y = np.ascontiguousarray(lv_y, dtype=np.int16)
    lv_cb = np.ascontiguousarray(lv_cb, dtype=np.int16)
    lv_cr = np.ascontiguousarray(lv_cr, dtype=np.int16)
    n_tiles = sp.tile_cols * sp.tile_rows
    col_b = np.asarray(sp.tile_col_bounds(), dtype=np.int32)
    row_b = np.asarray(sp.tile_row_bounds(), dtype=np.int32)
    sizes = np.zeros(n_tiles, dtype=np.int32)
    payload = np.empty(w * h * 3 + 4096, dtype=np.uint8)
    if sao_params is not None:
        sao_arr = np.ascontiguousarray(sao_params, dtype=np.int32)
        sao_ptr = sao_arr.ctypes.data_as(ctypes.c_void_p)
        sao_on = 1
    else:
        sao_ptr = None
        sao_on = 0
    if dir_map is not None:
        dir_arr = np.ascontiguousarray(dir_map, dtype=np.int8)
        mv_arr = np.ascontiguousarray(mv_map, dtype=np.int16)
        dir_ptr = dir_arr.ctypes.data_as(ctypes.c_void_p)
        mv_ptr = mv_arr.ctypes.data_as(ctypes.c_void_p)
    else:
        dir_ptr = mv_ptr = None
    mctx_p, cd_p, cm_p, cr_p, rm_p, _keep = _marshal_mctx(mctx, ref_map)
    total = lib.hevc_entropy_slice_tiled(
        w, h, sp.log2_ctu, sp.bit_depth, qp_y, qp_cb, qp_cr,
        int(lossless), int(sp.transquant_bypass_enabled), dm, mm,
        dm.shape[1], int(slice_type), dir_ptr, mv_ptr,
        lv_y, lv_cb, lv_cr, states, mps, N_CTX, offsets,
        sp.tile_cols, sp.tile_rows, col_b, row_b, sao_on, sao_ptr,
        int(sdh) | (int(ts) << 1) | (int(rqt) << 2), payload, sizes,
        mctx_p, cd_p, cm_p, cr_p, rm_p)
    subs = []
    off = 0
    for t in range(n_tiles):
        subs.append(payload[off:off + int(sizes[t])].tobytes())
        off += int(sizes[t])
    assert off == total
    return subs


def deblock_picture_native(planes, sp, depth_map, slice_qp, qp_cb, qp_cr,
                           motion=None, tusplit=None) -> None:
    """C++ deblocking filter (spec 8.7.2), in place on planes.y/cb/cr.

    Drop-in for spec.deblock.deblock_picture on the native path; motion is
    the (mf_mv, mf_ref, mf_cbf, mf_inter) tuple exported by
    encode_slice_native (None => all-intra, BS=2 everywhere)."""
    lib = _load()
    dm = np.ascontiguousarray(depth_map, dtype=np.int8)
    for p in (planes.y, planes.cb, planes.cr):
        assert p.dtype == np.int32 and p.flags["C_CONTIGUOUS"]
    ts_p = None
    if tusplit is not None:
        ts_arr = np.ascontiguousarray(tusplit, dtype=np.uint8)
        ts_p = ts_arr.ctypes.data_as(ctypes.c_void_p)
    if motion is None:
        mv_p = ref_p = cbf_p = None
    else:
        mf_mv = np.ascontiguousarray(motion[0], dtype=np.int32)
        mf_ref = np.ascontiguousarray(motion[1], dtype=np.int32)
        mf_cbf = np.ascontiguousarray(motion[2], dtype=np.uint8)
        mv_p = mf_mv.ctypes.data_as(ctypes.c_void_p)
        ref_p = mf_ref.ctypes.data_as(ctypes.c_void_p)
        cbf_p = mf_cbf.ctypes.data_as(ctypes.c_void_p)
    lib.hevc_deblock_picture(
        planes.y, planes.cb, planes.cr, sp.coded_width, sp.coded_height,
        sp.log2_ctu, sp.log2_max_tu, sp.bit_depth, slice_qp, qp_cb, qp_cr,
        dm, mv_p, ref_p, cbf_p, ts_p)


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class CppCabacEncoder:
    """Drop-in replacement for spec.cabac.CabacEncoder backed by the C++
    engine. Same (name, idx) interface; adds the native residual fast path
    used by spec.residual.encode_residual."""

    def __init__(self, writer, ctx: ContextSet) -> None:
        lib = _load()
        states = np.zeros(N_CTX, dtype=np.uint8)
        mps = np.zeros(N_CTX, dtype=np.uint8)
        for name, off in CTX_OFFSETS.items():
            n = len(ctx.state[name])
            states[off:off + n] = ctx.state[name]
            mps[off:off + n] = ctx.mps[name]
        self._lib = lib
        self._h = lib.cabac_enc_new(
            states.tobytes(), mps.tobytes(), N_CTX,
            CTX_OFFSETS["last_sig_coeff_prefix"],
            CTX_OFFSETS["coded_sub_block_flag"],
            CTX_OFFSETS["sig_coeff_flag"],
            CTX_OFFSETS["coeff_abs_level_greater1_flag"],
            CTX_OFFSETS["coeff_abs_level_greater2_flag"])
        self.w = writer
        self._finished = False

    def encode_bin(self, name: str, idx: int, binval: int) -> None:
        self._lib.cabac_enc_bin(self._h, CTX_OFFSETS[name] + idx, binval)

    def encode_bypass(self, binval: int) -> None:
        self._lib.cabac_enc_bypass(self._h, binval)

    def encode_bypass_bits(self, value: int, n: int) -> None:
        self._lib.cabac_enc_bypass_bits(self._h, value, n)

    def encode_terminate(self, binval: int) -> None:
        self._lib.cabac_enc_terminate(self._h, binval)

    def encode_residual_native(self, levels: np.ndarray, log2_size: int,
                               c_idx: int, scan_idx: int,
                               sdh: bool = False) -> None:
        lv = np.ascontiguousarray(levels, dtype=np.int32)
        self._lib.cabac_enc_residual(
            self._h, lv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            log2_size, c_idx, scan_idx, int(sdh))

    def finish(self) -> None:
        trail = ctypes.c_uint32(0)
        nbits = self._lib.cabac_enc_finish(self._h, ctypes.byref(trail))
        size = self._lib.cabac_enc_size(self._h)
        buf = ctypes.create_string_buffer(size)
        self._lib.cabac_enc_copy(self._h, buf)
        for b in buf.raw:
            self.w.write_bits(b, 8)
        if nbits:
            self.w.write_bits(trail.value, nbits)
        self._lib.cabac_enc_free(self._h)
        self._h = None
        self._finished = True

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cabac_enc_free(self._h)
