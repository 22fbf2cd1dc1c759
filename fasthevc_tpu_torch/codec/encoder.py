"""Encoder top of the port: the all-intra routes of TpuEncoder and its
GOP device route (low-delay P and random access).

Counterpart of fasthevc_tpu/codec/encoder.py TpuEncoder, routed as
TpuEncoder routes:
  * the all-intra device route (`_encode_all_intra_device`, the default for
    CTU 32, 8-bit): search, exact commit, deblock, SAO and checksum of each
    group of FRAME_GROUP frames run on the torch device
    (`device_pipeline.encode_group_device`), two groups in flight; the
    host emits CABAC from the levels (`cabac_cpp.entropy_slice_native`)
    on a thread pool;
  * the pipelined all-intra route (`_encode_all_intra_pipelined`, CTU 64
    or FASTHEVC_FORCE_CLASSIC set): the search runs on the device and the
    C++ slice engine (`cabac_cpp.encode_slice_native`) commits each frame,
    deblocks, applies SAO and emits CABAC on a thread pool;
  * the GOP device route (`_encode_gop_device`, orders of I, P and B
    slices under the device route's conditions): dependency batches of P
    or B frames through `device_pipeline.encode_inter_group_device` with
    the references in a DPB on the device, I frames through
    `encode_group_device`, CABAC with TMVP on the host.
With `fast_partition` every route's search takes the partition CNN's
depth maps (kernel K13, one launch per batch) in place of its split
decisions, as TpuEncoder's routes do.  Given the same config, frames and
CNN, the stream is the one TpuEncoder writes on the same route.

Every other route (the classic per-frame P/B loop, rate control, ...)
raises NotImplementedError naming the ROADMAP.md item that ports it;
nothing falls back to the JAX package.
"""

from __future__ import annotations

import collections
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import cabac_cpp
from .gop import SLICE_B, SLICE_I, SLICE_P, coding_order, ref_lists
from ..config import EncoderConfig
from ..spec import bitstream as bs
from ..spec.cabac import ContextSet
from ..spec.ctu import Planes, tu_qps
from ..spec.encoder import config_to_sp
from ..spec.inter import MotionCtx
from ..spec.syntax import (
    SliceHeader,
    write_picture_hash_sei,
    write_pps,
    write_slice_header,
    write_sps,
    write_vps,
)
from ..utils.video import HASH_CHECKSUM, pad_plane, picture_hash

from ..models.partition_cnn import as_partition_cnn
from .device_pipeline import (device_path_ok, encode_group_device,
                              encode_inter_group_device)
from .search import search_intra_maps_batch

# Frames per search dispatch (fasthevc_tpu/codec/encoder.py FRAME_GROUP),
# and the most P or B pictures of one batch on the GOP route.
FRAME_GROUP = 8

# One picture of a coding order on the GOP route: its reference lists (as
# CVS-local POCs), the signalled RPS deltas, its QP and its CVS (the POC of
# its IDR).
_Picture = collections.namedtuple(
    "_Picture", "poc cvs_poc st l0 l1 deltas qp is_idr idr")


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to fasthevc_tpu_torch yet "
        f"(ROADMAP.md queue 1, item {item}); use fasthevc_tpu.TpuEncoder")


class TorchEncoder:
    """Encoder on a torch device (all-intra, low-delay P and random-access
    orders).

    cfg: the port's EncoderConfig.  device: where the device work runs
    ("cuda" launches the hand-written kernels; "cpu" runs their plain
    twins).  plain=True runs the twins on any device, to hold the kernels
    against them.  partition_params: the partition CNN of
    `cfg.fast_partition` (a parameter tree of either package, as
    models.load_params returns it, or a models.PartitionCNN), converted
    once to the device.  `timing` holds the phase times of the last encode:
    device_s, wait_s, entropy_s and wall_s on the device routes; search_s,
    wait_s, commit_s and wall_s on the pipelined route; `spans` each
    batch's time on the device.
    """

    def __init__(self, cfg: EncoderConfig, device="cuda",
                 plain: bool = False, partition_params=None) -> None:
        if not isinstance(cfg, EncoderConfig):
            raise TypeError("TorchEncoder takes fasthevc_tpu_torch.config."
                            f"EncoderConfig, not {type(cfg).__module__}."
                            f"{type(cfg).__name__}")
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        self.plain = plain
        if not cabac_cpp.available():
            raise RuntimeError("TorchEncoder needs the C++ slice engine "
                               "(fasthevc_tpu_torch.cabac_cpp); no g++ found")
        self.sp = config_to_sp(cfg)
        self.sp.deblocking_disabled = not cfg.deblocking
        self.sp.sao_enabled = cfg.sao
        self.sp.transform_skip_enabled = bool(cfg.transform_skip)
        self.lambda_sqrt = self._lambda_sqrt(cfg.qp)
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
        # the learned fast-partition model: its depth maps replace the
        # search's split decisions (encoder.py:99-103)
        self.cnn = None
        if cfg.fast_partition:
            if partition_params is None:
                raise ValueError("fast_partition requires partition_params "
                                 "(train via models.train_self_distilled)")
            self.cnn = as_partition_cnn(partition_params, self.device,
                                        self.sp.log2_ctu)
        if cfg.lossless:
            raise _unported("lossless", "11")
        if cfg.search_recon_refs:
            raise _unported("search_recon_refs (two-pass search)", "11")
        if cfg.target_bitrate > 0:
            raise _unported("rate control (target_bitrate > 0)", "7")
        if cfg.hrd:
            raise _unported("HRD SEI on the per-frame route", "11")
        self.timing: dict = {}  # phase times of the last encode()
        self.spans: list = []   # each batch's span on the device

    @staticmethod
    def _lambda_sqrt(qp: int) -> float:
        """sqrt of the RD lambda 0.57 * 2^((qp - 12) / 3), in f64."""
        return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))

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
        # the reference's routing (fasthevc_tpu/codec/encoder.py:240-268):
        # FASTHEVC_FORCE_CLASSIC selects the pipelined all-intra route or
        # the classic per-frame P/B loop; every route runs on the card
        device_ok = (not os.environ.get("FASTHEVC_FORCE_CLASSIC")
                     and device_path_ok(self.cfg, sp))
        if all(st == SLICE_I for _, st, _, _ in order):
            if device_ok:
                return self._encode_all_intra_device(frames, start_poc, out,
                                                     on_frame)
            return self._encode_all_intra_pipelined(frames, start_poc, out,
                                                    on_frame)
        if not device_ok:
            raise _unported("the classic per-frame P/B route (CTU 64, high "
                            "bit depth, weighted prediction or "
                            "FASTHEVC_FORCE_CLASSIC)", "11")
        return self._encode_gop_device(frames, start_poc, out, order,
                                       on_frame)

    def _upload(self, planes: list) -> torch.Tensor:
        t = torch.from_numpy(np.stack(planes))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _upload_group(self, frames, idxs) -> tuple:
        """Frames idxs of [(y, cb, cr)] edge-padded to the CTU grid and
        uploaded: ([F, PH, PW], [F, PH/2, PW/2], [F, PH/2, PW/2])."""
        sp = self.sp
        ctu = 1 << sp.log2_ctu
        pw = -(-sp.coded_width // ctu) * ctu
        ph = -(-sp.coded_height // ctu) * ctu
        dtype = np.uint8 if sp.bit_depth == 8 else np.int32
        return tuple(
            self._upload([pad_plane(np.asarray(frames[i][p], np.int32), h, w)
                          .astype(dtype) for i in idxs])
            for p, h, w in ((0, ph, pw), (1, ph // 2, pw // 2),
                            (2, ph // 2, pw // 2)))

    def _run_batches(self, frames, batches, run_batch, frame_job,
                     span_key: str, job_key: str, on_fetch=None) -> list:
        """Run batches of frames on the device, two in flight, and the
        frames of each finished batch through `frame_job` on a thread pool
        (its native calls release the GIL, so frames overlap each other and
        the device).

        batches: lists of frame indices, in dispatch order.  run_batch(bi,
        y, cb, cr) enqueues batch bi's device work on its uploaded planes
        and returns a dict of output tensors, which come back into pinned
        host memory behind a CUDA event.  on_fetch(bi, host), if given, runs
        in this thread on each batch's outputs (numpy), in batch order, and
        returns one extra argument per frame for frame_job(host, i, j,
        extra), which turns frame j of the batch, frame i of the clip, into
        (nal_bytes, planes).  Returns the frames' results in dispatch
        order, and sets self.timing: span_key, the batches' spans on the
        device (host time on the CPU), summed; wait_s, the host's time
        blocked on them; job_key, the frame jobs' times summed over the
        pool's threads; wall_s; and self.spans, each batch's span."""
        cuda = self.device.type == "cuda"
        timing = {span_key: 0.0, "wait_s": 0.0, job_key: 0.0}
        spans: list = []
        pending: dict = {}

        def dispatch(bi):
            planes = self._upload_group(frames, batches[bi])
            t_host = time.perf_counter()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            res = run_batch(bi, *planes)
            if not cuda:
                spans.append(time.perf_counter() - t_host)
                pending[bi] = (res, None, None)
                return
            host = {}
            for k, v in res.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            pending[bi] = (host, start, end)

        def job(host, i, j, extra):
            t = time.perf_counter()
            return frame_job(host, i, j, extra), time.perf_counter() - t

        t0 = time.perf_counter()
        workers = max(2, min(4, os.cpu_count() or 2))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = []
            for bi in range(min(2, len(batches))):
                dispatch(bi)
            for bi, idxs in enumerate(batches):
                tw = time.perf_counter()
                host, start, end = pending.pop(bi)
                if end is not None:
                    end.synchronize()
                    spans.append(start.elapsed_time(end) / 1e3)
                host = {k: v.numpy() for k, v in host.items()}
                timing["wait_s"] += time.perf_counter() - tw
                if bi + 2 < len(batches):
                    dispatch(bi + 2)
                extra = (on_fetch(bi, host) if on_fetch is not None
                         else [None] * len(idxs))
                futs += [ex.submit(job, host, i, j, extra[j])
                         for j, i in enumerate(idxs)]
            results = []
            for fut in futs:
                result, dt = fut.result()
                results.append(result)
                timing[job_key] += dt
        timing[span_key] = sum(spans)
        timing["wall_s"] = time.perf_counter() - t0
        self.timing = timing
        self.spans = spans
        return results

    def _groups(self, n: int) -> list:
        """The all-intra routes' batches: runs of FRAME_GROUP frames."""
        group = min(self.cfg.frame_group or FRAME_GROUP, n)
        return [list(range(s, min(s + group, n))) for s in range(0, n, group)]

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

        def run_group(_, ys, cbs, crs):
            return encode_group_device(
                ys, cbs, crs, self.lambda_sqrt, qp_y, qp_cb, qp_cr, qp,
                sp.log2_ctu, sp.log2_min_cu, sp.coded_width,
                sp.coded_height, bool(sp.sign_data_hiding),
                not sp.deblocking_disabled, sao_on, tbx, tby,
                rd_cands=cfg.num_intra_rd_candidates, rdoq=bool(cfg.rdoq),
                checksum=cksum_hash, plain=self.plain, cnn=self.cnn, qp=qp)

        def emit_frame(res, i, j, _):
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

        results = self._run_batches(frames, self._groups(len(frames)),
                                    run_group, emit_frame, "device_s",
                                    "entropy_s")
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

        def run_group(_, ys, cbs, crs):
            return {"packed": search_intra_maps_batch(
                ys, self.lambda_sqrt, sp.log2_ctu, sp.log2_min_cu,
                sp.coded_width, sp.coded_height, cb_batch=cbs, cr_batch=crs,
                rd_cands=self.cfg.num_intra_rd_candidates,
                plain=self.plain, cnn=self.cnn, qp=self.cfg.qp)}

        def commit(res, i, j, _):
            # every all-intra frame is an IDR: CVS-local POC is 0
            return self._encode_frame_native(srcs[i], res["packed"][j])

        results = self._run_batches([(s.y, s.cb, s.cr) for s in srcs],
                                    self._groups(len(srcs)), run_group,
                                    commit, "search_s", "commit_s")
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

    def _encode_gop_device(self, frames, start_poc, out, order, on_frame):
        """Device route of coding orders with I, P and B slices: the
        counterpart of fasthevc_tpu/codec/encoder.py:518-965 without rate
        control.  A pre-pass resolves every picture's reference lists and
        packs batches of up to FRAME_GROUP P or B pictures whose signalled
        references all lie in earlier batches (in low-delay P each picture
        references its predecessor, so batches hold one; a random-access
        GOP-16 goes as [16] [8] [4, 12] [2, 6, 10, 14] [the odd POCs], and
        the stream holds its pictures in that batch order, as the
        reference's device route writes them); I pictures go alone through
        encode_group_device, P and B batches through
        encode_inter_group_device, two batches in flight.  References live
        in a DPB of uint8 recon planes on the device, each evicted after
        the last batch that reads it; the host keeps each picture's motion
        for TMVP and emits CABAC on a thread pool.  timing: device_s,
        wait_s, entropy_s, wall_s."""
        sp = self.sp
        cfg = self.cfg
        ctu = 1 << sp.log2_ctu
        tbx = tuple(int(b) * ctu for b in sp.tile_col_bounds()[1:-1])
        tby = tuple(int(b) * ctu for b in sp.tile_row_bounds()[1:-1])
        deblock_on = not sp.deblocking_disabled
        sao_on = bool(sp.sao_enabled)
        gh, gw = sp.coded_height >> 3, sp.coded_width >> 3
        cksum_hash = cfg.hash_type == HASH_CHECKSUM

        # ---- pre-pass: reference lists (encoder.py:561-586)
        entries = []
        sim_dpb: set = set()
        idr = start_poc
        for poc, slice_type, ref_deltas, qp_off in order:
            is_idr = slice_type == SLICE_I
            if is_idr:
                idr = poc
                sim_dpb = set()
            cvs_poc = poc - idr
            st, _, _, deltas = ref_lists({p: None for p in sim_dpb}, cvs_poc,
                                         slice_type, ref_deltas, is_idr)
            l0 = ([cvs_poc - d for d in deltas[0]]
                  + [cvs_poc + d for d in deltas[1]])
            l1 = ([cvs_poc + d for d in deltas[1]]
                  + [cvs_poc - d for d in deltas[0]])
            nr = max(1, min(2, cfg.num_ref_per_list))
            entries.append(_Picture(poc, cvs_poc, st, l0[:nr], l1[:nr],
                                    deltas, min(max(cfg.qp + qp_off, 0), 51),
                                    is_idr, idr))
            sim_dpb.add(cvs_poc)

        # ---- the dependency batcher (encoder.py:600-646): a batch starts
        # at the earliest pending picture and takes later pictures of its
        # slice type and CVS whose whole signalled RPS is already
        # dispatched
        batches = []
        pending = list(entries)
        done: set = set()
        while pending:
            e0 = pending[0]
            taken = [0]
            if e0.st != SLICE_I:
                for k in range(1, len(pending)):
                    if len(taken) >= FRAME_GROUP:
                        break
                    e = pending[k]
                    if e.st == SLICE_I:
                        break
                    refs = ([(e.idr, e.cvs_poc - d) for d in e.deltas[0]]
                            + [(e.idr, e.cvs_poc + d) for d in e.deltas[1]])
                    if (e.st == e0.st and e.idr == e0.idr
                            and all(r in done for r in refs)):
                        taken.append(k)
            batch = [pending[k] for k in taken]
            pending = [e for k, e in enumerate(pending) if k not in taken]
            done.update((e.idr, e.cvs_poc) for e in batch)
            batches.append(batch)

        # ---- exact DPB liveness: evict after the last batch that reads
        last_use: dict = {}
        for bi, batch in enumerate(batches):
            for e in batch:
                last_use[(e.idr, e.cvs_poc)] = bi
                if e.st != SLICE_I:
                    for p in e.l0 + e.l1:
                        last_use[(e.idr, p)] = bi
        evict: dict = {}
        for key, bi in last_use.items():
            evict.setdefault(bi, []).append(key)

        qp_cache: dict = {}

        def qps_of(qp):
            if qp not in qp_cache:
                qp_cache[qp] = tu_qps(sp, qp)
            return qp_cache[qp]

        dev_dpb: dict = {}     # (idr, cvs_poc) -> (y, cb, cr) uint8
        motion_dpb: dict = {}  # (idr, cvs_poc) -> (dir, mv, ref POC)

        def run_batch(bi, ys, cbs, crs):
            batch = batches[bi]
            common = dict(log2_ctu=sp.log2_ctu, log2_min_cu=sp.log2_min_cu,
                          coded_w=sp.coded_width, coded_h=sp.coded_height,
                          sdh=bool(sp.sign_data_hiding),
                          deblock_on=deblock_on, sao_on=sao_on,
                          tile_bounds_x=tbx, tile_bounds_y=tby,
                          rd_cands=cfg.num_intra_rd_candidates,
                          rdoq=bool(cfg.rdoq), checksum=cksum_hash,
                          plain=self.plain, cnn=self.cnn,
                          # the CNN's qp feature is the batch's first
                          # picture's for every picture of the batch
                          # (encoder.py:723, 767-769)
                          qp=batch[0].qp)
            if batch[0].st == SLICE_I:
                qp = batch[0].qp
                qy, qcb, qcr = qps_of(qp)
                res = encode_group_device(ys, cbs, crs,
                                          self._lambda_sqrt(qp), qy, qcb,
                                          qcr, qp, **common)
            else:
                def stack(li, pi):
                    """[F, 2, H, W] plane pi of each picture's list li: its
                    two references, the first twice when it has one."""
                    pairs = [(e.idr, e.l1 if li else e.l0) for e in batch]
                    return torch.stack([torch.stack(
                        [dev_dpb[(idr, lst[0])][pi],
                         dev_dpb[(idr, lst[-1])][pi]]) for idr, lst in pairs])

                tq = [qps_of(e.qp) for e in batch]
                is_b = batch[0].st == SLICE_B
                res = encode_inter_group_device(
                    ys, cbs, crs, stack(0, 0), stack(0, 1), stack(0, 2),
                    [self._lambda_sqrt(e.qp) for e in batch],
                    [t[0] for t in tq], [t[1] for t in tq],
                    [t[2] for t in tq], [e.qp for e in batch],
                    search_range=cfg.search_range,
                    nref0=[len(e.l0) for e in batch],
                    r1=(tuple(stack(1, pi) for pi in range(3)) if is_b
                        else None),
                    nref1=[len(e.l1) for e in batch] if is_b else None,
                    **common)
            for j, e in enumerate(batch):
                dev_dpb[(e.idr, e.cvs_poc)] = (res["rec_y"][j],
                                               res["rec_cb"][j],
                                               res["rec_cr"][j])
            for key in evict.get(bi, ()):
                dev_dpb.pop(key, None)
            return res

        def motion_ctx(e):
            """The picture's MotionCtx, with TMVP from the collocated
            picture's recorded motion (encoder.py:678-698): l0[0] for P,
            l1[0] for B (HM's default)."""
            if e.st == SLICE_I:
                return None
            col_from_l0 = e.st != SLICE_B
            m = MotionCtx(cur_poc=e.cvs_poc, l0_pocs=tuple(e.l0),
                          l1_pocs=tuple(e.l1), tmvp=False,
                          col_from_l0=col_from_l0, log2_ctu=sp.log2_ctu)
            lst = e.l0 if col_from_l0 else e.l1
            col = motion_dpb.get((e.idr, lst[0])) if lst else None
            if sp.temporal_mvp_enabled and col is not None:
                m.tmvp = True
                m.col_poc = lst[0]
                m.col_dir, m.col_mv, m.col_refpoc = col
            return m

        def on_fetch(bi, host):
            """Record each picture's motion (canonical collocated form,
            ref indices resolved to POCs) before its dependants emit, then
            their MotionCtx; evict motion on the DPB's schedule."""
            pk = host["packed"]
            ctxs = []
            for j, e in enumerate(batches[bi]):
                r8 = pk[j, :gh, :gw, 7:9].astype(np.int32)
                rp = np.zeros((gh, gw, 2), np.int32)
                for li, lst in ((0, e.l0), (1, e.l1)):
                    if lst:
                        lut = np.asarray(lst, np.int32)
                        rp[..., li] = lut[np.clip(r8[..., li], 0,
                                                  len(lst) - 1)]
                motion_dpb[(e.idr, e.cvs_poc)] = (
                    np.ascontiguousarray(pk[j, :gh, :gw, 2]
                                         .astype(np.int8)),
                    np.ascontiguousarray(pk[j, :gh, :gw, 3:7]
                                         .astype(np.int16)), rp)
                ctxs.append((e, motion_ctx(e)))
            for key in evict.get(bi, ()):
                motion_dpb.pop(key, None)
            return ctxs

        def emit_frame(res, i, j, extra):
            e, mctx = extra
            qp_y, qp_cb, qp_cr = qps_of(e.qp)
            pk = res["packed"][j, :gh, :gw]
            kw = {}
            if e.st != SLICE_I:
                kw = dict(slice_type=e.st,
                          dir_map=np.ascontiguousarray(pk[..., 2]
                                                       .astype(np.int8)),
                          mv_map=np.ascontiguousarray(pk[..., 3:7]
                                                      .astype(np.int16)),
                          ref_map=np.ascontiguousarray(pk[..., 7:9]
                                                       .astype(np.int8)))
            init_type = 0 if e.is_idr else (1 if e.st == SLICE_P else 2)
            subs = cabac_cpp.entropy_slice_native(
                sp, qp_y, qp_cb, qp_cr,
                np.ascontiguousarray(pk[..., 0].astype(np.int8)),
                np.ascontiguousarray(pk[..., 1].astype(np.int8)),
                res["lv_y"][j], res["lv_cb"][j], res["lv_cr"][j],
                ContextSet(init_type, e.qp),
                sao_params=res["sao"][j] if sao_on else None,
                sdh=sp.sign_data_hiding, ts=sp.transform_skip_enabled,
                rqt=sp.max_transform_hierarchy_depth_inter > 0, mctx=mctx,
                **kw)
            nal_type = bs.NAL_IDR_W_RADL if e.is_idr else bs.NAL_TRAIL_R
            sh = SliceHeader(
                slice_type=e.st, slice_qp=e.qp, is_idr=e.is_idr,
                poc_lsb=e.cvs_poc & ((1 << sp.log2_max_poc_lsb) - 1),
                ref_pocs_before=() if e.is_idr else e.deltas[0],
                ref_pocs_after=() if e.is_idr else e.deltas[1],
                num_ref_idx_l0=max(1, len(e.l0)),
                num_ref_idx_l1=max(1, len(e.l1)),
                temporal_mvp=bool(mctx and mctx.tmvp),
                collocated_from_l0=mctx.col_from_l0 if mctx else True,
                sao_luma=sao_on,
                sao_chroma=sao_on,
                entry_points=tuple(len(s) for s in subs[:-1]))
            w = write_slice_header(sh, sp, nal_type)
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
            nal = bs.write_nal(nal_type, w.get_bytes())
            nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                                write_picture_hash_sei(md5s, cfg.hash_type))
            return nal, planes

        results = self._run_batches(
            frames, [[e.poc - start_poc for e in b] for b in batches],
            run_batch, emit_frame, "device_s", "entropy_s", on_fetch)
        recons: dict = {}
        for e, (nal_bytes, planes) in zip(
                [e for b in batches for e in b], results):
            out += nal_bytes
            recons[e.poc] = planes
            if on_frame is not None:
                on_frame(e.poc, e.is_idr, bytes(nal_bytes))
        return bytes(out), [recons[start_poc + i] for i in range(len(frames))]
