"""Encoder top of the port: the all-intra routes of TpuEncoder.

Counterpart of fasthevc_tpu/codec/encoder.py TpuEncoder on its two
all-intra routes, chosen as TpuEncoder chooses them:
  * the device route (`_encode_all_intra_device`, the default for CTU 32,
    8-bit): search, exact commit, deblock, SAO and checksum of each group
    of FRAME_GROUP frames run on the torch device
    (`device_pipeline.encode_group_device`), two groups in flight; the
    host emits CABAC from the levels (`cabac_cpp.entropy_slice_native`)
    on a thread pool;
  * the pipelined route (`_encode_all_intra_pipelined`, CTU 64 or
    FASTHEVC_FORCE_CLASSIC set): the search runs on the device and the
    C++ slice engine (`cabac_cpp.encode_slice_native`) commits each frame,
    deblocks, applies SAO and emits CABAC on a thread pool.
Given the same config and frames, the stream is the one TpuEncoder writes
on the same route.

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
from fasthevc_tpu.utils.video import HASH_CHECKSUM, pad_plane, picture_hash

from .device_pipeline import device_path_ok, encode_group_device
from .search import search_intra_maps_batch

# Frames per search dispatch (fasthevc_tpu/codec/encoder.py FRAME_GROUP).
FRAME_GROUP = 8


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to fasthevc_tpu_torch yet "
        f"(ROADMAP.md queue 1, item {item}); use fasthevc_tpu.TpuEncoder")


class TorchEncoder:
    """All-intra encoder on a torch device.

    device: where the device work runs ("cuda" launches the hand-written
    kernels; "cpu" runs their plain twins).  plain=True runs the twins on
    any device, to hold the kernels against them.  `timing` holds the
    phase times of the last encode: device_s, wait_s, entropy_s and
    wall_s on the device route; search_s, wait_s, commit_s and wall_s on
    the pipelined route.
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
        # the reference's routing (fasthevc_tpu/codec/encoder.py:240-256):
        # FASTHEVC_FORCE_CLASSIC selects the pipelined route; both routes
        # run on the card
        if (not os.environ.get("FASTHEVC_FORCE_CLASSIC")
                and device_path_ok(self.cfg, sp)):
            return self._encode_all_intra_device(frames, start_poc, out,
                                                 on_frame)
        return self._encode_all_intra_pipelined(frames, start_poc, out,
                                                on_frame)

    def _upload(self, planes: list) -> torch.Tensor:
        t = torch.from_numpy(np.stack(planes))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _upload_group(self, frames, i0: int, i1: int) -> tuple:
        """Frames i0..i1 of [(y, cb, cr)] edge-padded to the CTU grid and
        uploaded: ([F, PH, PW], [F, PH/2, PW/2], [F, PH/2, PW/2])."""
        sp = self.sp
        ctu = 1 << sp.log2_ctu
        pw = -(-sp.coded_width // ctu) * ctu
        ph = -(-sp.coded_height // ctu) * ctu
        dtype = np.uint8 if sp.bit_depth == 8 else np.int32
        return tuple(
            self._upload([pad_plane(np.asarray(frames[i][p], np.int32), h, w)
                          .astype(dtype) for i in range(i0, i1)])
            for p, h, w in ((0, ph, pw), (1, ph // 2, pw // 2),
                            (2, ph // 2, pw // 2)))

    def _run_groups(self, frames, run_group, frame_job, span_key: str,
                    job_key: str) -> list:
        """Run the frame groups on the device, two in flight, and the
        frames of each finished group through `frame_job` on a thread pool
        (its native calls release the GIL, so frames overlap each other and
        the device).

        run_group(y, cb, cr) enqueues one group's device work on its
        uploaded planes and returns a dict of output tensors, which come
        back into pinned host memory behind a CUDA event; frame_job(host,
        i, j) turns frame j of a group's outputs (numpy), frame i of the
        clip, into (nal_bytes, planes).  Returns the frames' results in
        order, and sets self.timing: span_key, the groups' spans on the
        device (host time on the CPU); wait_s, the host's time blocked on
        them; job_key, the frame jobs' times summed over the pool's
        threads; wall_s."""
        n = len(frames)
        group = min(self.cfg.frame_group or FRAME_GROUP, n)
        starts = list(range(0, n, group))
        cuda = self.device.type == "cuda"
        timing = {span_key: 0.0, "wait_s": 0.0, job_key: 0.0}
        pending: dict = {}

        def dispatch(ci):
            planes = self._upload_group(frames, starts[ci],
                                        min(starts[ci] + group, n))
            t_host = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            res = run_group(*planes)
            if not cuda:
                timing[span_key] += time.perf_counter() - t_host
                pending[ci] = (res, None, None)
                return
            host = {}
            for k, v in res.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pending[ci] = (host, start, end)

        def job(host, i, j):
            t = time.perf_counter()
            return frame_job(host, i, j), time.perf_counter() - t

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
                    timing[span_key] += start.elapsed_time(end) / 1e3
                host = {k: v.numpy() for k, v in host.items()}
                timing["wait_s"] += time.perf_counter() - tw
                if ci + 2 < len(starts):
                    dispatch(ci + 2)
                futs += [ex.submit(job, host, s + j, j)
                         for j in range(min(group, n - s))]
            results = []
            for fut in futs:
                result, dt = fut.result()
                results.append(result)
                timing[job_key] += dt
        timing["wall_s"] = time.perf_counter() - t0
        self.timing = timing
        return results

    @staticmethod
    def _emit(results, out, start_poc, on_frame):
        recons = []
        for i, (nal_bytes, planes) in enumerate(results):
            out += nal_bytes
            recons.append(planes)
            if on_frame is not None:
                on_frame(start_poc + i, True, bytes(nal_bytes))
        return bytes(out), recons

    def _encode_all_intra_device(self, frames, start_poc, out, on_frame):
        """Device route: each group of frames runs search, exact commit,
        deblock, SAO and checksum on the device; the host emits CABAC from
        the fetched levels.  Counterpart of
        fasthevc_tpu/codec/encoder.py:330-464, 496-516, without rate
        control.  timing: device_s, wait_s, entropy_s, wall_s."""
        sp = self.sp
        cfg = self.cfg
        ctu = 1 << sp.log2_ctu
        qp = cfg.qp
        qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
        tbx = tuple(int(b) * ctu for b in sp.tile_col_bounds()[1:-1])
        tby = tuple(int(b) * ctu for b in sp.tile_row_bounds()[1:-1])
        sao_on = bool(sp.sao_enabled)
        cksum_hash = cfg.hash_type == HASH_CHECKSUM
        gh, gw = sp.coded_height >> 3, sp.coded_width >> 3

        def run_group(ys, cbs, crs):
            return encode_group_device(
                ys, cbs, crs, self.lambda_sqrt, qp_y, qp_cb, qp_cr, qp,
                sp.log2_ctu, sp.log2_min_cu, sp.coded_width,
                sp.coded_height, bool(sp.sign_data_hiding),
                not sp.deblocking_disabled, sao_on, tbx, tby,
                rd_cands=cfg.num_intra_rd_candidates, rdoq=bool(cfg.rdoq),
                checksum=cksum_hash, plain=self.plain)

        def emit_frame(res, i, j):
            depth = np.ascontiguousarray(res["packed"][j, :gh, :gw, 0]
                                         .astype(np.int8))
            mode = np.ascontiguousarray(res["packed"][j, :gh, :gw, 1]
                                        .astype(np.int8))
            subs = cabac_cpp.entropy_slice_native(
                sp, qp_y, qp_cb, qp_cr, depth, mode, res["lv_y"][j],
                res["lv_cb"][j], res["lv_cr"][j], ContextSet(0, qp),
                sao_params=res["sao"][j] if sao_on else None,
                sdh=sp.sign_data_hiding, ts=sp.transform_skip_enabled)
            sh = SliceHeader(
                slice_type=SLICE_I, slice_qp=qp, is_idr=True, poc_lsb=0,
                sao_luma=sao_on, sao_chroma=sao_on,
                entry_points=tuple(len(s) for s in subs[:-1]))
            w = write_slice_header(sh, sp, bs.NAL_IDR_W_RADL)
            for s_bytes in subs:
                w.append_bytes(s_bytes)
            planes = Planes.__new__(Planes)
            planes.y = res["rec_y"][j].astype(np.int32)
            planes.cb = res["rec_cb"][j].astype(np.int32)
            planes.cr = res["rec_cr"][j].astype(np.int32)
            if cksum_hash:
                md5s = [int(v).to_bytes(4, "big") for v in res["cksum"][j]]
            else:
                md5s = picture_hash((planes.y, planes.cb, planes.cr),
                                    cfg.hash_type)
            nal = bs.write_nal(bs.NAL_IDR_W_RADL, w.get_bytes())
            nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                                write_picture_hash_sei(md5s, cfg.hash_type))
            return nal, planes

        results = self._run_groups(frames, run_group, emit_frame,
                                   "device_s", "entropy_s")
        return self._emit(results, out, start_poc, on_frame)

    def _encode_all_intra_pipelined(self, frames, start_poc, out, on_frame):
        """Pipelined route: the search of each group runs on the device;
        the C++ slice engine commits, filters and emits each frame.
        timing: search_s, wait_s, commit_s, wall_s."""
        sp = self.sp
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

        def run_group(ys, cbs, crs):
            return {"packed": search_intra_maps_batch(
                ys, self.lambda_sqrt, sp.log2_ctu, sp.log2_min_cu,
                sp.coded_width, sp.coded_height, cb_batch=cbs, cr_batch=crs,
                rd_cands=self.cfg.num_intra_rd_candidates,
                plain=self.plain)}

        def commit(res, i, j):
            # every all-intra frame is an IDR: CVS-local POC is 0
            return self._encode_frame_native(srcs[i], res["packed"][j])

        results = self._run_groups([(s.y, s.cb, s.cr) for s in srcs],
                                   run_group, commit, "search_s",
                                   "commit_s")
        return self._emit(results, out, start_poc, on_frame)

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
