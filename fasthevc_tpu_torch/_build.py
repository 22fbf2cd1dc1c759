"""Builds the package's CUDA kernels and binds them through ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together) and the objects are linked into one shared library with a plain
C interface, at first use, into `build/fasthevc_tpu_torch/` under the
checkout root, keyed by a hash of the sources and flags (a stale library is
never loaded).  No PyTorch headers are included, so a build takes seconds.

Each C entry point launches on the stream it is given (PyTorch's current
stream) and returns `cudaGetLastError()`; `check` raises if that is not 0.

`LAUNCHES` counts kernel launches by kernel name.  Each wrapper adds one
(`launched`) where it launches its kernel, and nowhere else, so a run can
show that its path went through the kernels.  The ranks of an in-process
mesh launch from several threads, so the count is taken under a lock.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fasthevc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


def launched(name: str, n: int = 1) -> None:
    """Count n launches of kernel `name` (thread-safe)."""
    with _count_lock:
        LAUNCHES[name] += n


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argument types (the stream, where one is taken,
# last)
_SIGNATURES = {
    # top, left, modes|NULL, mode_tab, out, B, n, lg, M, edge, max_val,
    # stream
    "fhv_intra_pred": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # top, left, src, mode_tab, out, B, n, lg, edge, max_val, stream
    "fhv_intra_satd": [_P] * 5 + [_I] * 5 + [_P],
    # top, left, src, satd|NULL, mode_bits|NULL, modes|NULL, mode_tab,
    # top_idx|NULL, cand_bits|NULL, res, B, n, K, edge, max_val, ls, stream
    "fhv_intra_rd_cands": [_P] * 10 + [_I] * 5 + [_F, _P],
    # src, preds, out, B, M, n, stream
    "fhv_satd": [_P, _P, _P, _I, _I, _I, _P],
    # res, levels, recon, B, lg, qp, bit_depth, dz, stream
    "fhv_tq_roundtrip": [_P, _P, _P] + [_I] * 5 + [_P],
    # res, dist, rate, B, lg, qp, bit_depth, dz, w0..w5, stream
    "fhv_tq_cost": [_P, _P, _P] + [_I] * 5 + [_F] * 6 + [_P],
    # res, rq, levels, dist, rate, B, n, lg, w0..w5, stream
    "fhv_sse_rate": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F,
                     _F, _P],
    # src y/cb/cr, depth, mode, dir, ipred y/cb/cr, rec y/cb/cr, lv
    # y/cb/cr, dct, scans, mode_tab, tiles, ntx, nty, ftab, itab, meta,
    # lams, qps, flags, order, F, ph, pw, coded_w, coded_h, sdh, rdoq,
    # bit_depth, stream
    "fhv_commit": [_P] * 19 + [_I, _I] + [_P] * 7 + [_I] * 8 + [_P],
    # in y/cb/cr, out y/cb/cr, depth, dir, mv, ref, cbf, beta_tab,
    # tc_tab, qps, F, H, W, log2_ctu, bit_depth, pass, x0, pic_w, stream
    "fhv_deblock": [_P] * 14 + [_I] * 8 + [_P],
    # lv_y, depth, cbf, F, H, W, log2_ctu, stream
    "fhv_deblock_cbf": [_P, _P, _P, _I, _I, _I, _I, _P],
    # in y/cb/cr, row pitches y/c, frame strides y/c, out y/cb/cr, depth,
    # dir, mv, ref, cbf, beta_tab, tc_tab, qps (host), F, H, W, log2_ctu,
    # bit_depth, x0, pic_w, stream
    "fhv_deblock_fused": ([_P] * 3 + [_I] * 2 + [_L] * 2 + [_P] * 11
                          + [_I] * 7 + [_P]),
    # lv_y, depth, cbf, F, H, W, log2_ctu, stream
    "fhv_deblock_cbf_ctu": [_P, _P, _P, _I, _I, _I, _I, _P],
    # src y/cb/cr, rec y/cb/cr, halo l/r y, cb, cr (or NULL), params, F, H,
    # W, log2_ctu, bit_depth, l_avail, r_avail, stream
    "fhv_sao_stats": [_P] * 13 + [_I] * 7 + [_P],
    # rec y/cb/cr, out y/cb/cr, halo l/r y, cb, cr (or NULL), params, F, H,
    # W, log2_ctu, bit_depth, l_avail, r_avail, stream
    "fhv_sao_apply": [_P] * 13 + [_I] * 7 + [_P],
    # src y/cb/cr, rec y/cb/cr, out y/cb/cr, halo l/r y, cb, cr (or NULL),
    # params, F, H, W, log2_ctu, bit_depth, l_avail, r_avail, stream
    "fhv_sao_fused": [_P] * 16 + [_I] * 7 + [_P],
    # planes, out, F, H, W, stream
    "fhv_checksum": [_P, _P, _I, _I, _I, _P],
    # in y/cb/cr, out y/cb/cr, sums (or NULL), pitches y/cb/cr, frame
    # strides y/cb/cr, F, H, W, stream
    "fhv_cast_checksum": [_P] * 7 + [_I] * 3 + [_L] * 3 + [_I] * 3 + [_P],
    # in, out, N, H, W, stream
    "fhv_downsample4": [_P, _P, _I, _I, _I, _P],
    # src, refs, center, out, R, H, W, n, rng, base_n, scale, clip, stream
    "fhv_sad_search": [_P] * 4 + [_I] * 8 + [_P],
    # src, refs, out16, out32, out64, R, H, W, c, k, rng, scale, clip,
    # stream
    "fhv_me_coarse": [_P] * 5 + [_I] * 8 + [_P],
    # y, refs, base16/32/64, out8/16/32/64, R, H, W, t, clip, stream
    "fhv_me_fine": [_P] * 9 + [_I] * 5 + [_P],
    # src, refs, mv_int, rate_tab, tab_len, ls, out_c, out_mv, out_p, R, H,
    # W, n, stream
    "fhv_subpel": [_P, _P, _P, _P, _I, _F, _P, _P, _P, _I, _I, _I, _I, _P],
    # refs, base, mvq, sel, raw, valid, R, H, W, n, tier, tier_w, stream
    "fhv_mc_sel": [_P] * 6 + [_I] * 6 + [_P],
    # src, refs, base, list 0 (mv, ridx, pred, cost, rate), list 1 (or
    # NULL), out mv/ridx/pred/cost/rate, L, ia0, ib0, ia1, ib1, H, W, n,
    # tier, tier_w, edge_col, ls2, stream
    "fhv_mc_merge": [_P] * 18 + [_I] * 11 + [_F, _P],
    # ref0, ref1, dir, mv, rmap, out, F, R0, R1, H, W, chroma, bit_depth,
    # stream
    "fhv_inter_pred": [_P] * 6 + [_I] * 7 + [_P],
    # ref0 y/cb/cr, ref1 y/cb/cr (or NULL), dir, mv, rmap (or NULL), out
    # y/cb/cr, F, R0, R1, H, W, bit_depth, stream
    "fhv_inter_planes": [_P] * 12 + [_I] * 6 + [_P],
    # src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, ls, pbi, cbi, R, H,
    # W, n, stream
    "fhv_bi_cost": [_P] * 8 + [_F, _P, _P] + [_I] * 4 + [_P],
    # src, refs, mv0, sel0, mv1, sel1, r0bits, r1bits, c0, c1, p0, p1, ls,
    # pred_sel, rate_sel, dchoice, R, H, W, n, stream
    "fhv_bi_select": [_P] * 12 + [_F] + [_P] * 3 + [_I] * 4 + [_P],
    # plane, dtype, qv, qp, theta, depth, logits, acts, F, PH, PW, log2_ctu,
    # T, smem bytes, stream
    "fhv_cnn_fwd": [_P, _I, _P, _F, _P, _P, _P, _P] + [_I] * 6 + [_P],
    # x, qv, labels, theta, acts, logits, scratch, grad, B, log2_ctu, inv_n,
    # stream
    "fhv_cnn_bwd": [_P] * 8 + [_I, _I, _F, _P],
    # B, log2_ctu, out (int64 [3]: scratch floats, grid, stages)
    "fhv_cnn_bwd_plan": [_I, _I, _P],
    # theta, grad, m, v, P, lr, b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2, stream
    "fhv_adam": [_P] * 4 + [_I] + [_F] * 8 + [_P],
    # x, qv, labels, theta, acts, logits, scratch, grad|NULL, m, v, bias
    # table, row, B, log2_ctu, inv_n, lr, b1, 1 - b1, b2, 1 - b2, eps,
    # stream
    "fhv_cnn_bwd_adam": [_P] * 11 + [_I] * 3 + [_F] * 7 + [_P],
    # plane descriptors (int64), n planes, stream
    "fhv_halo": [_P, _I, _P],
    "fhv_halo_rows": [_P, _I, _P],
}

_lib = None
_lock = threading.Lock()


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfhv_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library of the current sources exists;
    returns the library's path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s, o in zip(cu, objs)]
    errors = []
    for src, proc in zip(cu, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                          f"{out}\n{err}")
    if not errors:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            errors.append(f"link ({proc.returncode}):\n{proc.stdout}\n"
                          f"{proc.stderr}")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def upload(t, device):
    """A small host tensor on `device` without a host synchronisation: the
    copy runs from pinned memory behind the work already queued on the
    current stream (a plain .to() from pageable memory waits for it)."""
    if t.device == device or device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def require_cuda(name: str, *tensors, dtype=None) -> None:
    """Raise unless every tensor is contiguous on one CUDA device (and of
    `dtype` where given): the kernels take nothing else."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
