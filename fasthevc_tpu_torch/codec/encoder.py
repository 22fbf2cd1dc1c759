"""Encoder top of the port: GPU intra search -> shared C++ commit, filters
and CABAC.

Counterpart of fasthevc_tpu/codec/encoder.py TpuEncoder on its pipelined
all-intra route (`_encode_all_intra_pipelined`): the decision search runs
on the torch device in groups of FRAME_GROUP frames, two groups in flight,
and the C++ slice engine (`fasthevc_tpu.cabac_cpp.encode_slice_native`)
commits each frame exactly, deblocks, applies SAO and emits CABAC on a
thread pool.  Given the same config and frames, the stream is the one
TpuEncoder writes on that route.

Every other route raises NotImplementedError naming the ROADMAP.md item
that ports it; nothing falls back to the JAX package.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fasthevc_tpu import cabac_cpp
from fasthevc_tpu.codec.gop import SLICE_I, coding_order
from fasthevc_tpu.config import EncoderConfig
from fasthevc_tpu.spec import bitstream as bs
from fasthevc_tpu.spec.cabac import ContextSet
from fasthevc_tpu.spec.ctu import Planes, tu_qps
from fasthevc_tpu.spec.encoder import config_to_sp
from fasthevc_tpu.spec.syntax import (
    SliceHeader,
    write_picture_hash_sei,
    write_pps,
    write_slice_header,
    write_sps,
    write_vps,
)
from fasthevc_tpu.utils.video import pad_plane, picture_hash

from .search import search_intra_maps_batch

# Frames per search dispatch (fasthevc_tpu/codec/encoder.py FRAME_GROUP).
FRAME_GROUP = 8


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to fasthevc_tpu_torch yet "
        f"(ROADMAP.md queue 1, item {item}); use fasthevc_tpu.TpuEncoder")


class TorchEncoder:
    """All-intra encoder with the intra search on a torch device.

    device: where the search runs ("cuda" launches the hand-written
    kernels; "cpu" runs their plain twins).  plain=True runs the twins on
    any device, to hold the kernels against them.
    """

    def __init__(self, cfg: EncoderConfig, device="cuda",
                 plain: bool = False) -> None:
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        self.plain = plain
        if not cabac_cpp.available():
            raise RuntimeError("TorchEncoder needs the C++ slice engine "
                               "(fasthevc_tpu.cabac_cpp); no g++ found")
        self.sp = config_to_sp(cfg)
        self.sp.deblocking_disabled = not cfg.deblocking
        self.sp.sao_enabled = cfg.sao
        self.sp.transform_skip_enabled = bool(cfg.transform_skip)
        self.lambda_sqrt = float(np.sqrt(0.57 * 2.0 ** ((cfg.qp - 12) / 3.0)))
        # the tools TpuEncoder itself refuses, then the unported routes
        if getattr(cfg, "slices", 1) > 1:
            raise NotImplementedError("multi-slice pictures run on the spec "
                                      "tier: use SpecEncoder")
        if cfg.scaling_lists:
            raise NotImplementedError("scaling lists run on the spec tier: "
                                      "use SpecEncoder")
        if cfg.wpp:
            raise NotImplementedError("WPP substreams run on the spec tier: "
                                      "use SpecEncoder")
        if cfg.rqt_intra:
            raise NotImplementedError("depth-1 intra RQT runs on the spec "
                                      "tier: use SpecEncoder")
        if cfg.fast_partition:
            raise _unported("fast_partition (the partition CNN)", "10")
        if cfg.lossless:
            raise _unported("lossless", "11")
        if cfg.search_recon_refs:
            raise _unported("search_recon_refs (two-pass search)", "11")
        if cfg.target_bitrate > 0:
            raise _unported("rate control (target_bitrate > 0)", "7")
        if cfg.hrd:
            raise _unported("HRD SEI on the per-frame route", "11")
        self.timing: dict = {}  # phase times of the last encode()

    def encode(self, frames, start_poc: int = 0, write_headers: bool = True,
               on_frame=None):
        """Encode [(y, cb, cr)] uint8 frames; returns (stream, recons)."""
        sp = self.sp
        out = bytearray()
        if write_headers:
            headers = (bs.write_nal(bs.NAL_VPS, write_vps(sp))
                       + bs.write_nal(bs.NAL_SPS, write_sps(sp))
                       + bs.write_nal(bs.NAL_PPS, write_pps(sp)))
            out += headers
            if on_frame is not None:
                on_frame(-1, False, bytes(headers))
        order = coding_order(self.cfg, len(frames), start_poc)
        if not all(st == SLICE_I for _, st, _, _ in order):
            raise _unported("P/B coding orders", "8-9")
        return self._encode_all_intra_pipelined(frames, start_poc, out,
                                                on_frame)

    def _upload(self, planes: list) -> torch.Tensor:
        t = torch.from_numpy(np.stack(planes))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _encode_all_intra_pipelined(self, frames, start_poc, out, on_frame):
        """Search each group of frames on the device (two groups in
        flight), then commit frames on a thread pool: the C++ slice engine
        releases the GIL, so commits overlap each other and the search."""
        sp = self.sp
        cfg = self.cfg
        ctu = 1 << sp.log2_ctu
        pw = -(-sp.coded_width // ctu) * ctu
        ph = -(-sp.coded_height // ctu) * ctu
        srcs = []
        for y, cb, cr in frames:
            src = Planes(sp)
            src.y[:] = pad_plane(np.asarray(y, np.int32), sp.coded_height,
                                 sp.coded_width)
            src.cb[:] = pad_plane(np.asarray(cb, np.int32),
                                  sp.coded_height // 2, sp.coded_width // 2)
            src.cr[:] = pad_plane(np.asarray(cr, np.int32),
                                  sp.coded_height // 2, sp.coded_width // 2)
            srcs.append(src)
        n = len(frames)
        group = min(cfg.frame_group or FRAME_GROUP, n)
        up_dtype = np.uint8 if sp.bit_depth == 8 else np.int32
        starts = list(range(0, n, group))
        pending: dict = {}
        cuda = self.device.type == "cuda"

        def dispatch(ci):
            rng = range(starts[ci], min(starts[ci] + group, n))
            ys = self._upload([pad_plane(srcs[i].y, ph, pw).astype(up_dtype)
                               for i in rng])
            cbs = self._upload([pad_plane(srcs[i].cb, ph // 2, pw // 2)
                                .astype(up_dtype) for i in rng])
            crs = self._upload([pad_plane(srcs[i].cr, ph // 2, pw // 2)
                                .astype(up_dtype) for i in rng])
            t_host = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            packed = search_intra_maps_batch(
                ys, self.lambda_sqrt, sp.log2_ctu, sp.log2_min_cu,
                sp.coded_width, sp.coded_height, cb_batch=cbs, cr_batch=crs,
                rd_cands=cfg.num_intra_rd_candidates, plain=self.plain)
            if not cuda:
                timing["search_s"] += time.perf_counter() - t_host
                pending[ci] = (packed, None, None)
                return
            # copy the maps back behind the search, without blocking
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pending[ci] = (host, start, end)

        def commit(src, packed):
            t = time.perf_counter()
            result = self._encode_frame_native(src, packed)
            return result, time.perf_counter() - t

        # search_s: the searches' spans on the device (host time on the
        # CPU); wait_s: host time blocked on search results; commit_s: the
        # frames' commit times summed over the pool's threads
        timing = {"search_s": 0.0, "wait_s": 0.0, "commit_s": 0.0}
        t0 = time.perf_counter()
        workers = max(2, min(4, os.cpu_count() or 2))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = []
            for ci in range(min(2, len(starts))):
                dispatch(ci)
            for ci, s in enumerate(starts):
                tw = time.perf_counter()
                host, start, end = pending.pop(ci)
                if end is not None:
                    end.synchronize()
                    timing["search_s"] += start.elapsed_time(end) / 1e3
                packed_all = host.numpy()
                timing["wait_s"] += time.perf_counter() - tw
                if ci + 2 < len(starts):
                    dispatch(ci + 2)
                for j in range(packed_all.shape[0]):
                    # every all-intra frame is an IDR: CVS-local POC is 0
                    futs.append(ex.submit(commit, srcs[s + j],
                                          packed_all[j]))
            results = []
            for fut in futs:
                result, dt = fut.result()
                results.append(result)
                timing["commit_s"] += dt
        timing["wall_s"] = time.perf_counter() - t0
        self.timing = timing
        recons = []
        for i, (nal_bytes, planes) in enumerate(results):
            out += nal_bytes
            recons.append(planes)
            if on_frame is not None:
                on_frame(start_poc + i, True, bytes(nal_bytes))
        return bytes(out), recons

    def _encode_frame_native(self, src, packed):
        """One IDR picture through the C++ slice engine: packed decision
        maps in, NAL units (slice + hash SEI) and recon planes out.  The I
        slice case of fasthevc_tpu/codec/encoder.py _encode_frame_native."""
        sp = self.sp
        cfg = self.cfg
        qp = cfg.qp
        gw, gh = sp.coded_width >> 3, sp.coded_height >> 3
        depth_map = np.ascontiguousarray(packed[:gh, :gw, 0].astype(np.int8))
        mode_map = np.ascontiguousarray(packed[:gh, :gw, 1].astype(np.int8))
        dir_map = np.ascontiguousarray(packed[:gh, :gw, 2].astype(np.int8))
        mv_map = np.ascontiguousarray(packed[:gh, :gw, 3:7].astype(np.int16))
        qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
        substreams, ry, rcb, rcr, _ = cabac_cpp.encode_slice_native(
            (src.y, src.cb, src.cr), sp, qp_y, qp_cb, qp_cr,
            depth_map, mode_map, ContextSet(0, qp), False,
            slice_type=SLICE_I, dir_map=dir_map, mv_map=mv_map,
            refs=((), ()), deblock=not sp.deblocking_disabled,
            sao=sp.sao_enabled, rdoq=cfg.rdoq, sdh=sp.sign_data_hiding,
            ts=sp.transform_skip_enabled,
            rqt=sp.max_transform_hierarchy_depth_inter > 0,
            mctx=None, ref_map=None, wp=None)
        nal_type = bs.NAL_IDR_W_RADL
        sh = SliceHeader(slice_type=SLICE_I, slice_qp=qp, is_idr=True,
                         poc_lsb=0, ref_pocs_before=(), ref_pocs_after=(),
                         num_ref_idx_l0=1, num_ref_idx_l1=1,
                         temporal_mvp=False, collocated_from_l0=True,
                         sao_luma=sp.sao_enabled, sao_chroma=sp.sao_enabled,
                         entry_points=tuple(len(s) for s in substreams[:-1]),
                         wp=None)
        w = write_slice_header(sh, sp, nal_type)
        for s_bytes in substreams:
            w.append_bytes(s_bytes)
        planes = Planes.__new__(Planes)
        planes.y, planes.cb, planes.cr = ry, rcb, rcr
        nal = bs.write_nal(nal_type, w.get_bytes())
        md5s = picture_hash((ry, rcb, rcr), cfg.hash_type)
        nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                            write_picture_hash_sei(md5s, cfg.hash_type))
        return nal, planes
