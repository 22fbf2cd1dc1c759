"""Encoder top of the port: every single-device route of TpuEncoder.

Counterpart of fasthevc_tpu/codec/encoder.py TpuEncoder, routed as
TpuEncoder routes (its :239-268):
  * the all-intra device route (`_encode_all_intra_device`, the default for
    CTU 32, 8-bit): search, exact commit, deblock, SAO and checksum of each
    group of FRAME_GROUP frames run on the torch device
    (`device_pipeline.encode_group_device`), two groups in flight; the
    host emits CABAC from the levels (`cabac_cpp.entropy_slice_native`)
    on a thread pool;
  * the pipelined all-intra route (`_encode_all_intra_pipelined`, CTU 64
    or FASTHEVC_FORCE_CLASSIC set, more than one picture, no rate
    control): the search runs on the device and the C++ slice engine
    (`cabac_cpp.encode_slice_native`) commits each frame, deblocks,
    applies SAO and emits CABAC on a thread pool;
  * the GOP device route (`_encode_gop_device`, orders of I, P and B
    slices under the device route's conditions): dependency batches of P
    or B frames through `device_pipeline.encode_inter_group_device` with
    the references in a DPB on the device, I frames through
    `encode_group_device`, CABAC with TMVP on the host;
  * the classic per-frame route (`_encode_classic`, everything else:
    P and B orders at CTU 64, above 8 bits, with weighted prediction,
    lossless or under FASTHEVC_FORCE_CLASSIC; one-picture all-intra off
    the device route; all-intra with rate control off the device route):
    each picture's search on the device, then the C++ slice engine,
    against a host DPB, with the two-pass recon-reference intra search of
    `search_recon_refs`.
Every route but the classic one needs the C++ slice engine.  On a host
without g++ (`_native_engine()` returns None, the one place the choice is
made; with g++ a failed build raises) every order takes the classic
route, whose pictures then go through the Python commit route
(`encode_frame`'s host branch, as TpuEncoder's): the search on the
device, then the commit, CABAC, deblocking and the hash in Python on the
host (spec/), with SAO off and no tiles.  Both commits give the same
stream from the same decisions.
Rate control (`target_bitrate`) runs on every route but the pipelined
one: the device routes then dispatch their batches one after another, a
batch's QPs chosen from the feedback of every picture emitted before it.
HRD buffering-period and pic-timing SEI are written where TpuEncoder
writes them (not on the pipelined route).  With `fast_partition` every
route's search takes the partition CNN's depth maps (kernel K13, one
launch per batch) in place of its split decisions, as TpuEncoder's routes
do.  Given the same config, frames and CNN, the stream is the one
TpuEncoder writes on the same route; nothing falls back to the JAX
package.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import cabac_cpp
from .gop import SLICE_B, SLICE_I, SLICE_P, coding_order, ref_lists
from ..config import EncoderConfig
from ..spec import bitstream as bs
from ..spec import ctu as ctu_mod
from ..spec import inter as inter_mod
from ..spec import residual as res_mod
from ..spec import transform as spec_tr
from ..spec.cabac import CabacEncoder, ContextSet
from ..spec.ctu import CHROMA_DM, CuDecision, FrameMaps, Planes, TuData, tu_qps
from ..spec.deblock import deblock_picture
from ..spec.encoder import config_to_sp, hrd_reorder_delay
from ..spec.inter import DIR_L0, DIR_L1, Motion, MotionCtx, RefPic, build_mctx
from ..spec.mc import mc_cu_motion
from ..spec.rdoq import rdoq_quantize
from ..spec.syntax import (
    SliceHeader,
    write_buffering_period_sei,
    write_pic_timing_sei,
    write_picture_hash_sei,
    write_pps,
    write_slice_header,
    write_sps,
    write_vps,
)
from ..spec.wp import estimate_wp_tables
from ..utils.video import HASH_CHECKSUM, pad_plane, picture_hash

from ..models.partition_cnn import as_partition_cnn
from .device_pipeline import (device_path_ok, encode_group_device,
                              encode_inter_group_device)
from .rate_control import RateController
from .search import (maps_to_trees, search_b_maps, search_intra_maps,
                     search_intra_maps_batch, search_p_maps)

# Frames per search dispatch of the all-intra routes
# (fasthevc_tpu/codec/encoder.py FRAME_GROUP), and at most RC_GROUP under
# rate control (encoder.py:366-369: small groups, more feedback points).
FRAME_GROUP = 8
RC_GROUP = 2

# One picture of a coding order on the GOP route: its reference lists (as
# CVS-local POCs), the signalled RPS deltas, its QP, its CVS (the POC of
# its IDR) and its access unit's index in the CVS (coding order).
_Picture = collections.namedtuple(
    "_Picture", "poc cvs_poc st l0 l1 deltas qp is_idr idr au")


def inter_batch_cap(sp) -> int:
    """The most P or B pictures of one GOP-route batch, by the reference's
    rule (fasthevc_tpu/codec/encoder.py:613-624): 4 when the coded picture
    has at least 1280x720 samples, 8 below; FASTHEVC_MAX_INTER_BATCH
    overrides either.  Both packages write pictures in batch order, so the
    cap sets the stream's picture order."""
    big = sp.coded_width * sp.coded_height >= 1280 * 720
    return int(os.environ.get("FASTHEVC_MAX_INTER_BATCH",
                              "4" if big else "8"))


def lambda_sqrt(qp: int) -> float:
    """sqrt of the RD lambda 0.57 * 2^((qp - 12) / 3), in f64 (the searches
    round it to f32)."""
    return float(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))


def _native_engine():
    """The C++ slice engine (the port's cabac_cpp), or None on a host
    without g++: the one place the route is chosen (encoder.py:58-66).
    With g++ the engine is built and loaded here, and a compile or load
    failure raises: a broken build never sends the pictures to the slower
    Python commit."""
    if shutil.which("g++") is None:
        return None
    cabac_cpp._load()
    return cabac_cpp


def _make_cabac(writer, ctx):
    """The Python commit route's bin coder: the C++ one where the engine
    loads, else spec.cabac's (encoder.py:69-79)."""
    if shutil.which("g++") is not None and cabac_cpp.available():
        return cabac_cpp.CppCabacEncoder(writer, ctx)
    return CabacEncoder(writer, ctx)


class _NativeMotion:
    """MotionField-alike view over the C++ engine's 4x4 motion export
    (what spec.inter.col_arrays reads: .inter, .mv, .ref_idx)."""

    def __init__(self, mf_mv, mf_ref, mf_inter) -> None:
        self.mv = mf_mv
        self.ref_idx = mf_ref
        self.inter = mf_inter.astype(bool)


class TorchEncoder:
    """Encoder on a torch device (all-intra, low-delay P and random-access
    orders, every tool TpuEncoder encodes on one device).

    cfg: the port's EncoderConfig.  device: where the device work runs
    ("cuda" launches the hand-written kernels; "cpu" runs their plain
    twins).  plain=True runs the twins on any device, to hold the kernels
    against them.  partition_params: the partition CNN of
    `cfg.fast_partition` (a parameter tree of either package, as
    models.load_params returns it, or a models.PartitionCNN), converted
    once to the device.  `timing` holds the phase times of the last encode:
    device_s, wait_s, entropy_s and wall_s on the device routes; search_s,
    wait_s, commit_s and wall_s on the pipelined route; search_s, commit_s
    and wall_s on the classic route (commit_s: the C++ engine's host time,
    or without it the Python commit's, CABAC's and deblocking's); `spans`
    each batch's (on the classic route each picture's search's) time on
    the device.  Without the C++ slice engine (no g++) the encoder runs
    the classic route only, with SAO off, and refuses tiles.
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
        native = _native_engine() is not None
        # lossless pictures are never filtered and never transform-skipped;
        # the Python commit route has no SAO pass (encoder.py:88-97)
        self.sp = config_to_sp(cfg)
        self.sp.deblocking_disabled = not cfg.deblocking or cfg.lossless
        self.sp.sao_enabled = cfg.sao and not cfg.lossless and native
        self.sp.transform_skip_enabled = (bool(cfg.transform_skip)
                                          and not cfg.lossless)
        self.lambda_sqrt = self._lambda_sqrt(cfg.qp)
        # the tools TpuEncoder itself refuses
        if self.sp.tiles_enabled and not native:
            raise NotImplementedError("tiles need the C++ slice engine "
                                      "(no g++): use SpecEncoder")
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
        self.timing: dict = {}  # phase times of the last encode()
        self.spans: list = []   # each batch's span on the device

    _lambda_sqrt = staticmethod(lambda_sqrt)

    def _rate_controller(self):
        """The R-lambda controller of `target_bitrate`, or None."""
        if self.cfg.target_bitrate <= 0:
            return None
        return RateController(self.cfg.target_bitrate, self.cfg.frame_rate,
                              self.sp.coded_width, self.sp.coded_height)

    def _warn_recon_refs(self, route: str) -> None:
        """search_recon_refs is read by the per-frame route only, as in the
        reference, which ignores it on its other routes (the streams stay
        the reference's)."""
        if self.cfg.search_recon_refs:
            warnings.warn(f"search_recon_refs takes effect only on the "
                          f"classic per-frame route; the {route} route "
                          f"searches with source references")

    def encode(self, frames, start_poc: int = 0, write_headers: bool = True,
               on_frame=None):
        """Encode [(y, cb, cr)] frames; returns (stream, recons)."""
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
        # the reference's routing (fasthevc_tpu/codec/encoder.py:239-268):
        # without the C++ slice engine every order takes the classic route;
        # every route runs its search on the device
        native = _native_engine() is not None
        device_ok = (native and not os.environ.get("FASTHEVC_FORCE_CLASSIC")
                     and device_path_ok(self.cfg, sp))
        if all(st == SLICE_I for _, st, _, _ in order):
            if device_ok:
                self._warn_recon_refs("all-intra device")
                return self._encode_all_intra_device(frames, start_poc, out,
                                                     on_frame)
            if native and self.cfg.target_bitrate == 0 and len(order) > 1:
                self._warn_recon_refs("pipelined all-intra")
                return self._encode_all_intra_pipelined(frames, start_poc,
                                                        out, on_frame)
        elif device_ok:
            self._warn_recon_refs("GOP device")
            return self._encode_gop_device(frames, start_poc, out, order,
                                           on_frame)
        return self._encode_classic(frames, start_poc, out, order, on_frame)

    def _padded_dims(self) -> tuple:
        """The coded picture's size rounded up to the CTU grid: (ph, pw)."""
        ctu = 1 << self.sp.log2_ctu
        return (-(-self.sp.coded_height // ctu) * ctu,
                -(-self.sp.coded_width // ctu) * ctu)

    def _upload(self, planes: list) -> torch.Tensor:
        t = torch.from_numpy(np.stack(planes))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _upload_padded(self, planes, h: int, w: int) -> torch.Tensor:
        """[n, h, w] of the planes edge-padded to h x w: uint8 at 8 bits,
        int32 above (encoder.py:998, :1063)."""
        dtype = np.uint8 if self.sp.bit_depth == 8 else np.int32
        return self._upload([pad_plane(np.asarray(p, np.int32), h, w)
                             .astype(dtype) for p in planes])

    def _upload_group(self, frames, idxs) -> tuple:
        """Frames idxs of [(y, cb, cr)] edge-padded to the CTU grid and
        uploaded: ([F, PH, PW], [F, PH/2, PW/2], [F, PH/2, PW/2])."""
        ph, pw = self._padded_dims()
        return tuple(self._upload_padded([frames[i][p] for i in idxs], h, w)
                     for p, h, w in ((0, ph, pw), (1, ph // 2, pw // 2),
                                     (2, ph // 2, pw // 2)))

    def _source(self, frame) -> Planes:
        """A frame's planes edge-padded to the coded size."""
        sp = self.sp
        ch, cw = sp.coded_height, sp.coded_width
        src = Planes(sp)
        src.y[:] = pad_plane(np.asarray(frame[0], np.int32), ch, cw)
        src.cb[:] = pad_plane(np.asarray(frame[1], np.int32), ch // 2,
                              cw // 2)
        src.cr[:] = pad_plane(np.asarray(frame[2], np.int32), ch // 2,
                              cw // 2)
        return src

    def _run_batches(self, frames, batches, run_batch, frame_job,
                     span_key: str, job_key: str, on_fetch=None, rc=None,
                     plan=None) -> list:
        """Run batches of frames on the device and the frames of each
        finished batch through `frame_job` on a thread pool (its native
        calls release the GIL, so frames overlap each other and the
        device).

        batches: lists of frame indices, in dispatch order.  run_batch(bi,
        y, cb, cr) enqueues batch bi's device work on its uploaded planes
        and returns a dict of output tensors, which come back into pinned
        host memory behind a CUDA event.  on_fetch(bi, host), if given, runs
        in this thread on each batch's outputs (numpy), in batch order, and
        returns one extra argument per frame for frame_job(host, i, j,
        extra), which turns frame j of the batch, frame i of the clip, into
        (nal_bytes, planes).  Without a rate controller `rc` two batches
        are in flight.  With one the batches run one after another:
        plan(bi) chooses batch bi's QPs just before its dispatch, after rc
        has been fed the bits of every frame of the batches before it, in
        order.  Returns the frames' results in dispatch order, and sets
        self.timing: span_key, the batches' spans on the device (host time
        on the CPU), summed; wait_s, the host's time blocked on them;
        job_key, the frame jobs' times summed over the pool's threads;
        wall_s; and self.spans, each batch's span."""
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

        def fetch(bi):
            tw = time.perf_counter()
            host, start, end = pending.pop(bi)
            if end is not None:
                end.synchronize()
                spans.append(start.elapsed_time(end) / 1e3)
            host = {k: v.numpy() for k, v in host.items()}
            timing["wait_s"] += time.perf_counter() - tw
            return host

        def job(host, i, j, extra):
            t = time.perf_counter()
            return frame_job(host, i, j, extra), time.perf_counter() - t

        def submit(ex, bi, host):
            idxs = batches[bi]
            extra = (on_fetch(bi, host) if on_fetch is not None
                     else [None] * len(idxs))
            return [ex.submit(job, host, i, j, extra[j])
                    for j, i in enumerate(idxs)]

        def take(fut):
            result, dt = fut.result()
            timing[job_key] += dt
            return result

        t0 = time.perf_counter()
        workers = max(2, min(4, os.cpu_count() or 2))
        results = []
        with ThreadPoolExecutor(max_workers=workers) as ex:
            if rc is None:
                futs = []
                for bi in range(min(2, len(batches))):
                    dispatch(bi)
                for bi in range(len(batches)):
                    host = fetch(bi)
                    if bi + 2 < len(batches):
                        dispatch(bi + 2)
                    futs += submit(ex, bi, host)
                results = [take(fut) for fut in futs]
            else:
                for bi in range(len(batches)):
                    plan(bi)
                    dispatch(bi)
                    for fut in submit(ex, bi, fetch(bi)):
                        results.append(take(fut))
                        rc.update_after_picture(len(results[-1][0]) * 8)
        timing[span_key] = sum(spans)
        timing["wall_s"] = time.perf_counter() - t0
        self.timing = timing
        self.spans = spans
        return results

    def _groups(self, n: int, cap: int = FRAME_GROUP) -> list:
        """The all-intra routes' batches: runs of FRAME_GROUP frames (or
        cfg.frame_group), at most `cap`."""
        group = min(self.cfg.frame_group or FRAME_GROUP, n, cap)
        return [list(range(s, min(s + group, n))) for s in range(0, n, group)]

    def _hrd_sei(self, is_idr: bool, au: int, cvs_poc: int,
                 reorder: int) -> bytes:
        """The prefix SEI of one access unit when the SPS carries HRD
        parameters: a buffering period at an IDR, then the picture's
        timing (its AU's index since the buffering period, and the output
        delay cvs_poc - au + reorder); empty without HRD."""
        sp = self.sp
        if not sp.hrd_enabled:
            return b""
        sei = b""
        if is_idr:
            sei += bs.write_nal(bs.NAL_PREFIX_SEI,
                                write_buffering_period_sei(sp))
        return sei + bs.write_nal(
            bs.NAL_PREFIX_SEI,
            write_pic_timing_sei(sp, au, cvs_poc - au + reorder))

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
        fasthevc_tpu/codec/encoder.py:330-516.  Under rate control the
        groups hold at most RC_GROUP frames and run one after another,
        each at the QP the controller gives it, with feedback after every
        picture (:366-369, :469-495); the CNN's qp feature stays cfg.qp
        (:407).  With HRD every picture, an IDR, is preceded by a
        buffering period and pic_timing(0, 0) (:453-460).  timing:
        device_s, wait_s, entropy_s, wall_s."""
        sp = self.sp
        cfg = self.cfg
        n = len(frames)
        ctu = 1 << sp.log2_ctu
        tbx = tuple(int(b) * ctu for b in sp.tile_col_bounds()[1:-1])
        tby = tuple(int(b) * ctu for b in sp.tile_row_bounds()[1:-1])
        sao_on = bool(sp.sao_enabled)
        cksum_hash = cfg.hash_type == HASH_CHECKSUM
        gh, gw = sp.coded_height >> 3, sp.coded_width >> 3
        rc = self._rate_controller()
        groups = self._groups(n, FRAME_GROUP if rc is None else RC_GROUP)
        qps = [cfg.qp] * n     # each frame's QP: its group's

        def plan(bi):
            # is_intra=False: the intra share of the bit budget is relative
            # to inter pictures, and here every picture is intra
            qp_g = rc.picture_qp(n, is_intra=False)
            for i in groups[bi]:
                qps[i] = qp_g

        def run_group(bi, ys, cbs, crs):
            qp = qps[groups[bi][0]]
            qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
            return encode_group_device(
                ys, cbs, crs, self._lambda_sqrt(qp), qp_y, qp_cb, qp_cr, qp,
                sp.log2_ctu, sp.log2_min_cu, sp.coded_width,
                sp.coded_height, bool(sp.sign_data_hiding),
                not sp.deblocking_disabled, sao_on, tbx, tby,
                rd_cands=cfg.num_intra_rd_candidates, rdoq=bool(cfg.rdoq),
                checksum=cksum_hash, plain=self.plain, cnn=self.cnn,
                qp=cfg.qp)

        def emit_frame(res, i, j, _):
            qp = qps[i]
            qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
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
            nal = (self._hrd_sei(True, 0, 0, 0)
                   + bs.write_nal(bs.NAL_IDR_W_RADL, w.get_bytes()))
            nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                                write_picture_hash_sei(md5s, cfg.hash_type))
            return nal, planes

        results = self._run_batches(frames, groups, run_group, emit_frame,
                                    "device_s", "entropy_s", rc=rc,
                                    plan=plan)
        return self._emit(results, out, start_poc, on_frame)

    def _encode_all_intra_pipelined(self, frames, start_poc, out, on_frame):
        """Pipelined route: the search of each group runs on the device;
        the C++ slice engine commits, filters and emits each frame
        (encoder.py:967-1046; no HRD SEI, as there).  timing: search_s,
        wait_s, commit_s, wall_s."""
        sp = self.sp
        srcs = [self._source(f) for f in frames]

        def run_group(_, ys, cbs, crs):
            return {"packed": search_intra_maps_batch(
                ys, self.lambda_sqrt, sp.log2_ctu, sp.log2_min_cu,
                sp.coded_width, sp.coded_height, cb_batch=cbs, cr_batch=crs,
                rd_cands=self.cfg.num_intra_rd_candidates,
                plain=self.plain, cnn=self.cnn, qp=self.cfg.qp)}

        def commit(res, i, j, _):
            # every all-intra frame is an IDR: CVS-local POC is 0
            return self._commit(srcs[i], res["packed"][j], self.cfg.qp)[:2]

        results = self._run_batches([(s.y, s.cb, s.cr) for s in srcs],
                                    self._groups(len(srcs)), run_group,
                                    commit, "search_s", "commit_s")
        return self._emit(results, out, start_poc, on_frame)

    @staticmethod
    def _motion_ctx(src, sp, poc: int, slice_type: int, refs) -> tuple:
        """The picture's MotionCtx (None for an I picture) and its explicit
        weighted-prediction tables, estimated from spec.wp where the PPS
        enables them for the slice type (encoder.py:1163-1172, :1316-1334),
        else None."""
        mctx = build_mctx(sp, poc, slice_type, list(refs[0]), list(refs[1]))
        wp = None
        if ((sp.weighted_pred and slice_type == SLICE_P)
                or (sp.weighted_bipred and slice_type == SLICE_B)) and refs[0]:
            wp = estimate_wp_tables((src.y, src.cb, src.cr), list(refs[0]),
                                    list(refs[1]), sp.bit_depth)
            if mctx is not None:
                mctx.wp = wp
        return mctx, wp

    @staticmethod
    def _slice_writer(sp, qp: int, poc: int, slice_type: int, refs,
                      ref_deltas, mctx, wp, entry_points=()) -> tuple:
        """The slice header written for one picture: (writer, NAL type)."""
        is_idr = slice_type == SLICE_I
        nal_type = bs.NAL_IDR_W_RADL if is_idr else bs.NAL_TRAIL_R
        sh = SliceHeader(slice_type=slice_type, slice_qp=qp, is_idr=is_idr,
                         poc_lsb=poc & ((1 << sp.log2_max_poc_lsb) - 1),
                         ref_pocs_before=() if is_idr else ref_deltas[0],
                         ref_pocs_after=() if is_idr else ref_deltas[1],
                         num_ref_idx_l0=max(1, len(refs[0])),
                         num_ref_idx_l1=max(1, len(refs[1])),
                         temporal_mvp=bool(mctx and mctx.tmvp),
                         collocated_from_l0=(mctx.col_from_l0 if mctx
                                             else True),
                         sao_luma=sp.sao_enabled, sao_chroma=sp.sao_enabled,
                         entry_points=tuple(entry_points), wp=wp)
        return write_slice_header(sh, sp, nal_type), nal_type

    def _picture_nal(self, w, nal_type: int, planes) -> bytes:
        """The slice NAL unit of writer w, then the recon's hash SEI."""
        md5s = picture_hash((planes.y, planes.cb, planes.cr),
                            self.cfg.hash_type)
        return (bs.write_nal(nal_type, w.get_bytes())
                + bs.write_nal(bs.NAL_SUFFIX_SEI,
                               write_picture_hash_sei(md5s,
                                                      self.cfg.hash_type)))

    def _commit(self, src, packed, qp: int, sp=None, poc: int = 0,
                slice_type: int = SLICE_I, refs=((), ()),
                ref_deltas=((), ())) -> tuple:
        """One picture through the C++ slice engine: packed decision maps
        in; (NAL units (slice + hash SEI), recon planes, MotionCtx, motion)
        out.  Counterpart of fasthevc_tpu/codec/encoder.py
        _encode_frame_native (:1111-1190): the search's reference indices,
        explicit weighted prediction from spec.wp where the PPS enables it
        for the slice type, lossless.  sp: the parameter set (by default
        the encoder's; the two-pass search's first pass turns the filters
        off in a copy)."""
        sp = self.sp if sp is None else sp
        cfg = self.cfg
        is_idr = slice_type == SLICE_I
        gw, gh = sp.coded_width >> 3, sp.coded_height >> 3
        pk = packed[:gh, :gw]
        qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
        init_type = 0 if is_idr else (1 if slice_type == SLICE_P else 2)
        mctx, wp = self._motion_ctx(src, sp, poc, slice_type, refs)
        native = _native_engine()
        substreams, ry, rcb, rcr, motion = native.encode_slice_native(
            (src.y, src.cb, src.cr), sp, qp_y, qp_cb, qp_cr,
            np.ascontiguousarray(pk[..., 0].astype(np.int8)),
            np.ascontiguousarray(pk[..., 1].astype(np.int8)),
            ContextSet(init_type, qp), cfg.lossless, slice_type=slice_type,
            dir_map=np.ascontiguousarray(pk[..., 2].astype(np.int8)),
            mv_map=np.ascontiguousarray(pk[..., 3:7].astype(np.int16)),
            refs=refs, deblock=not sp.deblocking_disabled,
            sao=sp.sao_enabled, rdoq=cfg.rdoq and not cfg.lossless,
            sdh=sp.sign_data_hiding, ts=sp.transform_skip_enabled,
            rqt=sp.max_transform_hierarchy_depth_inter > 0, mctx=mctx,
            ref_map=None if is_idr
            else np.ascontiguousarray(pk[..., 7:9].astype(np.int8)),
            wp=wp)
        w, nal_type = self._slice_writer(
            sp, qp, poc, slice_type, refs, ref_deltas, mctx, wp,
            [len(s) for s in substreams[:-1]])
        for s_bytes in substreams:
            w.append_bytes(s_bytes)
        planes = Planes.__new__(Planes)
        planes.y, planes.cb, planes.cr = ry, rcb, rcr
        return (self._picture_nal(w, nal_type, planes), planes, mctx,
                _NativeMotion(motion[0], motion[1], motion[3]))

    def _search(self, src, refs, slice_type: int, qp: int, recon_ref,
                timing: dict, spans: list,
                host_branch: bool = False) -> np.ndarray:
        """One picture's search on the device, the counterpart of
        fasthevc_tpu/codec/encoder.py _search_dispatch (:1048-1109): intra
        with the source chroma (and the recon-reference planes when
        given) for an IDR or a picture without references, B when list 1
        has a reference, else P over list 0's first two references; the
        CNN's override at the picture's QP.  Returns the packed [gh, gw, 9]
        maps.  host_branch: search as encode_frame's host branch does
        (:1245-1302, :196-210), for the Python commit route: the P and B
        searches at their default RD shortlist of 3 (the intra search
        keeps num_intra_rd_candidates), the CNN asked at cfg.qp.  Adds the
        search's time on the device (host time on the CPU) to
        timing["search_s"] and spans."""
        sp, cfg = self.sp, self.cfg
        ph, pw = self._padded_dims()
        geo = (sp.log2_ctu, sp.log2_min_cu, sp.coded_width, sp.coded_height)
        kw = dict(rd_cands=cfg.num_intra_rd_candidates, plain=self.plain,
                  cnn=self.cnn, qp=cfg.qp if host_branch else qp)
        ls = self._lambda_sqrt(qp)
        cuda = self.device.type == "cuda"
        t_host = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        y = self._upload_padded([src.y], ph, pw)
        if slice_type == SLICE_I or not refs[0]:
            def chroma(planes):
                return (self._upload_padded([planes.cb], ph // 2, pw // 2)[0],
                        self._upload_padded([planes.cr], ph // 2, pw // 2)[0])

            rf = {}
            if recon_ref is not None:
                rf["ref_y"] = self._upload_padded([recon_ref.y], ph, pw)[0]
                rf["ref_cb"], rf["ref_cr"] = chroma(recon_ref)
            packed = search_intra_maps(y[0], ls, *geo, *chroma(src), **rf,
                                       **kw)
        else:
            def refs_of(lst):
                """[1, R, PH, PW]: the list's first two references."""
                return self._upload_padded([r.y for r in lst[:2]], ph,
                                           pw)[None]

            if host_branch:
                kw["rd_cands"] = 3
            if slice_type == SLICE_B and refs[1]:
                packed = search_b_maps(y, refs_of(refs[0]), refs_of(refs[1]),
                                       ls, *geo, cfg.search_range, **kw)[0]
            else:
                packed = search_p_maps(y, refs_of(refs[0]), ls, *geo,
                                       cfg.search_range, **kw)[0]
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            packed = packed.cpu()
            spans.append(start.elapsed_time(end) / 1e3)
        else:
            spans.append(time.perf_counter() - t_host)
        timing["search_s"] += spans[-1]
        return packed.numpy()

    def _encode_frame(self, src, poc: int, slice_type: int, refs, deltas,
                      qp: int, timing: dict, spans: list,
                      first_pass: bool = False) -> tuple:
        """One picture of the classic route (fasthevc_tpu/codec/encoder.py
        encode_frame, :1192-1376): its search on the device, then the C++
        commit, or without the engine the Python commit route.  With
        search_recon_refs an intra-searched picture is coded twice
        (:1220-1243): pass 1, with deblocking and SAO off in a copy of the
        parameter set, gives the reconstruction whose pixels are pass 2's
        intra references; pass 1 itself searches with source references.
        Returns (nal, planes, mctx, motion) of the picture (pass 2's)."""
        sp = self.sp
        recon_ref = None
        if first_pass:
            sp = dataclasses.replace(sp, deblocking_disabled=True,
                                     sao_enabled=False)
        elif self.cfg.search_recon_refs and (slice_type == SLICE_I
                                             or not refs[0]):
            recon_ref = self._encode_frame(src, poc, slice_type, refs,
                                           deltas, qp, timing, spans,
                                           first_pass=True)[1]
        native = _native_engine() is not None
        packed = self._search(src, refs, slice_type, qp, recon_ref, timing,
                              spans, host_branch=not native)
        t = time.perf_counter()
        commit = self._commit if native else self._commit_python
        result = commit(src, packed, qp, sp, poc, slice_type, refs, deltas)
        timing["commit_s"] += time.perf_counter() - t
        return result

    def encode_frame(self, frame, poc: int = 0, slice_type: int = SLICE_I,
                     refs=((), ()), ref_deltas=((), ()), qp=None) -> tuple:
        """One picture on the classic route, TpuEncoder.encode_frame
        (fasthevc_tpu/codec/encoder.py:1192-1376): frame (y, cb, cr) at
        CVS-local `poc`, refs the two lists of spec.inter.RefPic,
        ref_deltas the signalled RPS, qp the slice QP (default cfg.qp).
        Returns (NAL units (slice + hash SEI), recon planes); the
        picture's MotionCtx and motion (for a later picture's TMVP) are
        left in _last_mctx and _last_motion, its times in timing and
        spans."""
        timing = {"search_s": 0.0, "commit_s": 0.0}
        spans: list = []
        t0 = time.perf_counter()
        nal, planes, self._last_mctx, self._last_motion = self._encode_frame(
            self._source(frame), poc, slice_type, refs, ref_deltas,
            self.cfg.qp if qp is None else qp, timing, spans)
        timing["wall_s"] = time.perf_counter() - t0
        self.timing, self.spans = timing, spans
        return nal, planes

    # ---- the Python commit route (no C++ slice engine) ---------------

    def _commit_python(self, src, packed, qp: int, sp, poc: int,
                       slice_type: int, refs, ref_deltas) -> tuple:
        """One picture through the Python commit route, encode_frame's host
        branch (fasthevc_tpu/codec/encoder.py:1303-1376): the packed
        decision maps as CTU trees, the exact commit in z-order (spec.ctu),
        the slice header and CABAC through _make_cabac, then deblocking
        (spec.deblock) and the hash SEI; no SAO.  Takes and returns what
        _commit does: (nal, planes, mctx, motion)."""
        is_idr = slice_type == SLICE_I
        self.qp, self.refs, self.slice_type = qp, refs, slice_type
        trees = maps_to_trees(packed, sp.coded_width, sp.coded_height,
                              sp.log2_ctu, sp.log2_min_cu)
        planes = Planes(sp)
        maps = FrameMaps(sp)
        mctx, wp = self._motion_ctx(src, sp, poc, slice_type, refs)
        maps.mctx = mctx
        qp_y, qp_cb, qp_cr = tu_qps(sp, qp)
        decisions = [(x0, y0, self._commit_node(src, planes, sp, x0, y0,
                                                sp.log2_ctu, 0, tree, maps,
                                                qp_y, qp_cb, qp_cr))
                     for x0, y0, tree in trees]
        w, nal_type = self._slice_writer(sp, qp, poc, slice_type, refs,
                                         ref_deltas, mctx, wp)
        init_type = 0 if is_idr else (1 if slice_type == SLICE_P else 2)
        enc = _make_cabac(w, ContextSet(init_type, qp))
        maps2 = FrameMaps(sp)
        maps2.mctx = mctx
        for i, (x0, y0, cu) in enumerate(decisions):
            ctu_mod.encode_ctu(enc, maps2, sp, x0, y0, cu, slice_type)
            enc.encode_terminate(1 if i == len(decisions) - 1 else 0)
        enc.finish()
        w.byte_align()
        if not sp.deblocking_disabled:
            deblock_picture(planes, sp, maps.depth[::2, ::2].astype(np.int32),
                            qp, qp_cb, qp_cr, maps=None if is_idr else maps)
        return self._picture_nal(w, nal_type, planes), planes, mctx, \
            maps.motion

    _rdoq_ctx_cache: dict = {}

    def _quantize_tb(self, coeffs, qp: int, is_intra: bool, blg: int,
                     c_idx: int, scan_idx: int):
        """Quantize one TB (encoder.py:135-152), as spec/encoder.py and the
        C++ engine's quantize_rdoq do: the trellis (spec.rdoq) at the
        picture QP's lambda when cfg.rdoq, else the HM dead-zone quantizer;
        the trellis' contexts by (init type 0 intra or 2 inter, qp)."""
        if not self.cfg.rdoq:
            return spec_tr.quantize(coeffs, qp, self.sp.bit_depth,
                                    is_intra=is_intra)
        key = (0 if is_intra else 2, qp)
        ctx = self._rdoq_ctx_cache.get(key)
        if ctx is None:
            ctx = self._rdoq_ctx_cache[key] = ContextSet(*key)
        lam = 0.57 * 2.0 ** ((self.qp - 12) / 3.0)
        return rdoq_quantize(coeffs, qp, self.sp.bit_depth, blg,
                             0 if c_idx == 0 else 1, scan_idx, lam, ctx)

    @staticmethod
    def _ibits(lv) -> int:
        """The integer level-bits estimate of the C++ engine's ts_bits_est
        (encoder.py:154-161): 2 + 2 * bit_length(|level|) a nonzero
        level."""
        if lv is None:
            return 0
        a = np.abs(lv)
        return int(sum(2 + 2 * int(v).bit_length() for v in a[a > 0]))

    def _ts_rd_choose(self, res, levels_dct, qp: int, is_intra: bool,
                      scan_idx: int) -> tuple:
        """Transform skip against the DCT for a 4x4 chroma TB
        (encoder.py:163-194, the C++ engine's commit_tb): SSE plus the
        picture QP's lambda times _ibits, the DCT kept on ties.  Returns
        (levels, ts)."""
        sp = self.sp
        bd = sp.bit_depth
        lam = 0.57 * 2.0 ** ((self.qp - 12) / 3.0)

        def cost(lv, ts):
            rq = np.zeros_like(res)
            if lv.any():
                deq = spec_tr.dequantize(lv, qp, bd)
                rq = (spec_tr.inverse_transform_skip(deq, bd) if ts
                      else spec_tr.inverse_transform(deq, bd, False))
            d = (res - rq).astype(np.int64)
            return float((d * d).sum()) + lam * self._ibits(lv)

        coeffs_ts = spec_tr.forward_transform_skip(res, bd)
        levels_ts = spec_tr.quantize(coeffs_ts, qp, bd, is_intra=is_intra)
        if sp.sign_data_hiding and levels_ts.any():
            levels_ts = res_mod.sdh_adjust(levels_ts, coeffs_ts, qp, bd, 2,
                                           scan_idx)
        if cost(levels_ts, True) < cost(levels_dct, False):
            return levels_ts, True
        return levels_dct, False

    def _commit_node(self, src, planes, sp, x, y, lg, depth, tree, maps,
                     qp_y, qp_cb, qp_cr) -> CuDecision:
        """Commit one node of a CTU tree (encoder.py:1380-1416): a split's
        children in z-order, an inter leaf, or an intra CU (chroma DM, its
        TUs split to the largest TU size)."""
        kind = tree[0]
        if kind == "split":
            cu = CuDecision(split=True, children=[])
            half = 1 << (lg - 1)
            for i, child in enumerate(tree[1]):
                if child is None:
                    cu.children.append(None)
                    continue
                cx, cy = x + (i & 1) * half, y + (i >> 1) * half
                cu.children.append(self._commit_node(
                    src, planes, sp, cx, cy, lg - 1, depth + 1, child,
                    maps, qp_y, qp_cb, qp_cr))
            return cu
        if kind == "ileaf":
            return self._commit_inter(src, planes, sp, x, y, lg, depth,
                                      tree[1], maps, qp_y, qp_cb, qp_cr)
        mode = tree[1]
        cu = CuDecision(split=False, luma_mode=mode, chroma_mode=CHROMA_DM,
                        bypass=self.cfg.lossless)
        if lg > sp.log2_max_tu:
            half = 1 << (lg - 1)
            for i in range(4):
                tx, ty = x + (i & 1) * half, y + (i >> 1) * half
                cu.tus.append(self._commit_tu(src, planes, sp, tx, ty,
                                              lg - 1, cu, qp_y, qp_cb,
                                              qp_cr))
        else:
            cu.tus.append(self._commit_tu(src, planes, sp, x, y, lg, cu,
                                          qp_y, qp_cb, qp_cr))
        size = 1 << lg
        maps.set_cu(x, y, size, depth, mode)
        maps.set_skip(x, y, size, False)
        maps.motion.set_intra_cu(
            x, y, size, any(tu.levels_y is not None for tu in cu.tus))
        return cu

    def _commit_inter(self, src, planes, sp, x, y, lg, depth, payload,
                      maps, qp_y, qp_cb, qp_cr) -> CuDecision:
        """Commit an inter leaf (encoder.py:1418-1568): merge when the
        search's motion is a merge candidate, else AMVP with the nearer
        predictor; the residual's TQ per component (transform skip by RD on
        4x4 chroma, bypass when lossless); under rqt_inter the depth-1
        transform split chosen by the C++ engine's integer-exact RD cost;
        skip when merged without residual; then the reconstruction.

        payload: (inter_dir, mv0, mv1, ref0, ref1) of the CU's tree leaf."""
        n = 1 << lg
        d, mv0_, mv1_, r0_, r1_ = payload
        is_b = self.slice_type == SLICE_B
        motion = Motion(d,
                        tuple(map(int, mv0_)) if d & DIR_L0 else (0, 0),
                        r0_ if d & DIR_L0 else -1,
                        tuple(map(int, mv1_)) if d & DIR_L1 else (0, 0),
                        r1_ if d & DIR_L1 else -1)
        cu = CuDecision(split=False, is_inter=True, motion=motion,
                        bypass=self.cfg.lossless)
        merge_cands = inter_mod.merge_candidates(maps, maps.motion, x, y, n,
                                                 is_b)
        if motion in merge_cands:
            cu.merge_flag = True
            cu.merge_idx = merge_cands.index(motion)
        else:
            if d & DIR_L0:
                amvp = inter_mod.amvp_candidates(maps, maps.motion, x, y,
                                                 n, 0, max(0, motion.ref0))
                cu.mvp_flag, cu.mvd = self._mvp(motion.mv0, amvp)
            if d & DIR_L1:
                amvp = inter_mod.amvp_candidates(maps, maps.motion, x, y,
                                                 n, 1, max(0, motion.ref1))
                cu.mvp_flag_l1, cu.mvd_l1 = self._mvp(motion.mv1, amvp)
        wp = maps.mctx.wp if maps.mctx else None
        pred_y, pred_cb, pred_cr = mc_cu_motion(
            motion, self.refs[0], self.refs[1], x, y, n, sp.bit_depth, wp=wp)
        max_val = (1 << sp.bit_depth) - 1

        def build_variant(split):
            n_t = 4 if split else 1
            t_lg = lg - 1 if split else lg
            half = n >> 1
            tus, sse_t, bits_t = [], 0, 0
            for i in range(n_t):
                oy, ox = (0, 0) if n_t == 1 else ((i >> 1) * half,
                                                  (i & 1) * half)
                tu = TuData()
                for ci, (srcp, predp, qp) in enumerate((
                        (src.y[y:y + n, x:x + n], pred_y, qp_y),
                        (src.cb[y >> 1:(y >> 1) + (n >> 1),
                                x >> 1:(x >> 1) + (n >> 1)], pred_cb,
                         qp_cb),
                        (src.cr[y >> 1:(y >> 1) + (n >> 1),
                                x >> 1:(x >> 1) + (n >> 1)], pred_cr,
                         qp_cr))):
                    sub = 0 if ci == 0 else 1
                    tn = 1 << (t_lg - sub)
                    o_y, o_x = oy >> sub, ox >> sub
                    res = (srcp[o_y:o_y + tn, o_x:o_x + tn]
                           - predp[o_y:o_y + tn, o_x:o_x + tn])
                    ts = False
                    if cu.bypass:
                        levels = res.astype(np.int32)
                        rq = res
                    else:
                        coeffs = spec_tr.forward_transform(
                            res, sp.bit_depth, False)
                        levels = self._quantize_tb(coeffs, qp, False,
                                                   t_lg - sub, ci, 0)
                        if sp.sign_data_hiding and levels.any():
                            levels = res_mod.sdh_adjust(
                                levels, coeffs, qp, sp.bit_depth,
                                t_lg - sub, 0)
                        if (sp.transform_skip_enabled and t_lg - sub == 2
                                and ci != 0):
                            levels, ts = self._ts_rd_choose(
                                res, levels, qp, False, 0)
                        if levels.any():
                            deq = spec_tr.dequantize(levels, qp,
                                                     sp.bit_depth)
                            rq = (spec_tr.inverse_transform_skip(
                                      deq, sp.bit_depth) if ts else
                                  spec_tr.inverse_transform(
                                      deq, sp.bit_depth, False))
                        else:
                            rq = np.zeros_like(res)
                    rec = np.clip(predp[o_y:o_y + tn, o_x:o_x + tn] + rq,
                                  0, max_val)
                    dd = (srcp[o_y:o_y + tn, o_x:o_x + tn]
                          - rec).astype(np.int64)
                    sse_t += int((dd * dd).sum())
                    bits_t += self._ibits(levels if levels.any() else None)
                    if not levels.any():
                        levels = None
                        ts = False
                    if ci == 0:
                        tu.levels_y = levels
                    elif ci == 1:
                        tu.levels_cb = levels
                        tu.ts_cb = ts
                    else:
                        tu.levels_cr = levels
                        tu.ts_cr = ts
                tus.append(tu)
            return tus, sse_t, bits_t

        forced = lg > sp.log2_max_tu
        tus_u, sse_u, bits_u = build_variant(forced)
        cu.tus = tus_u
        if (not forced and not cu.bypass
                and sp.max_transform_hierarchy_depth_inter > 0
                and lg > sp.log2_min_tu + 1):
            # the split candidate (its chroma TBs stay at least 4x4)
            tus_s, sse_s, bits_s = build_variant(True)
            lam = 0.57 * 2.0 ** ((self.qp - 12) / 3.0)
            cost_u = float(sse_u) + lam * (bits_u + 4)
            cost_s = float(sse_s) + lam * (bits_s + 13)
            if cost_s < cost_u:
                cu.tus = tus_s
                cu.tu_split = True
        cbf_any = any(t.levels_y is not None or t.levels_cb is not None
                      or t.levels_cr is not None for t in cu.tus)
        if cu.merge_flag and not cbf_any:
            cu.skip = True
            cu.tus = []
            cu.tu_split = False
        ctu_mod._reconstruct_inter_cu(planes, sp, x, y, lg, cu, self.refs,
                                      self.qp, wp=wp)
        maps.set_cu(x, y, n, depth, -1)
        maps.set_skip(x, y, n, cu.skip)
        cbf_y = any(t.levels_y is not None for t in cu.tus)
        maps.motion.set_cu(x, y, n, cu.motion, cbf_y)
        ctu_mod.apply_tu_cbf(maps, x, y, n, cu)
        return cu

    @staticmethod
    def _mvp(mv, amvp) -> tuple:
        """The AMVP predictor nearer to mv (the first on ties) and the MVD:
        (mvp flag, mvd)."""
        b0 = abs(mv[0] - amvp[0][0]) + abs(mv[1] - amvp[0][1])
        b1 = abs(mv[0] - amvp[1][0]) + abs(mv[1] - amvp[1][1])
        flag = 0 if b0 <= b1 else 1
        p = amvp[flag]
        return flag, (mv[0] - p[0], mv[1] - p[1])

    def _commit_tu(self, src, planes, sp, x, y, lg, cu, qp_y, qp_cb,
                   qp_cr) -> TuData:
        """Commit one intra TU (encoder.py:1570-1617): per component the
        prediction from the reconstruction so far, the TQ (DST on 4x4
        luma, transform skip by RD on 4x4 chroma, bypass when lossless) and
        the reconstruction."""
        tu = TuData()
        cmode = ctu_mod.chroma_mode_from_cu(cu)
        for c_idx, mode, qp in ((0, cu.luma_mode, qp_y),
                                (1, cmode, qp_cb), (2, cmode, qp_cr)):
            if c_idx == 0:
                bx, by, blg = x, y, lg
            else:
                bx, by, blg = x >> 1, y >> 1, lg - 1
            n = 1 << blg
            s = src.plane(c_idx)[by:by + n, bx:bx + n]
            pred = ctu_mod.predict_block(planes, sp, bx, by, blg, mode,
                                         c_idx)
            res = s - pred
            ts = False
            if cu.bypass:
                levels = res.astype(np.int32)
            else:
                scan_idx = res_mod.intra_scan_idx(blg, c_idx, mode)
                coeffs = spec_tr.forward_transform(res, sp.bit_depth,
                                                   c_idx == 0 and blg == 2)
                levels = self._quantize_tb(coeffs, qp, True, blg, c_idx,
                                           scan_idx)
                if sp.sign_data_hiding and levels.any():
                    levels = res_mod.sdh_adjust(
                        levels, coeffs, qp, sp.bit_depth, blg, scan_idx)
                if (sp.transform_skip_enabled and blg == 2
                        and c_idx != 0):
                    levels, ts = self._ts_rd_choose(res, levels, qp, True,
                                                    scan_idx)
            if not levels.any():
                levels = None
                ts = False
            ctu_mod.reconstruct_tb(planes, sp, bx, by, blg, mode, c_idx,
                                   levels, qp, cu.bypass, ts)
            if c_idx == 0:
                tu.levels_y = levels
            elif c_idx == 1:
                tu.levels_cb = levels
                tu.ts_cb = ts
            else:
                tu.levels_cr = levels
                tu.ts_cr = ts
        return tu

    def _encode_classic(self, frames, start_poc, out, order, on_frame):
        """The classic per-frame route, the counterpart of TpuEncoder.encode's
        loop (fasthevc_tpu/codec/encoder.py:269-326): one picture a step, in
        coding order, against a host DPB of spec.inter.RefPic records (the
        engine's recon planes, its motion for TMVP, the picture's list
        POCs).  The QP comes from the rate controller (feedback after every
        picture) or the temporal-layer cascade; with HRD a buffering period
        at each IDR and a pic timing for every picture precede its NAL
        units (:289-298).  timing: search_s (the searches on the device),
        commit_s (the C++ engine's host time, or without it the Python
        commit's, CABAC's and deblocking's), wall_s; spans: each search's
        time on the device."""
        cfg = self.cfg
        rc = self._rate_controller()
        reorder = hrd_reorder_delay(cfg)
        timing = {"search_s": 0.0, "commit_s": 0.0}
        spans: list = []
        t0 = time.perf_counter()
        recons: dict = {}
        dpb: dict = {}
        idr = start_poc
        au = 0
        for poc, slice_type, ref_deltas, qp_off in order:
            is_idr = slice_type == SLICE_I
            if is_idr:
                idr, dpb, au = poc, {}, 0
            cvs_poc = poc - idr
            out += self._hrd_sei(is_idr, au, cvs_poc, reorder)
            au += 1
            slice_type, refs_l0, refs_l1, deltas = ref_lists(
                dpb, cvs_poc, slice_type, ref_deltas, is_idr,
                cfg.num_ref_per_list)
            if rc is not None:
                qp = rc.picture_qp(len(frames), is_intra=is_idr)
            else:
                qp = min(max(cfg.qp + qp_off, 0), 51)
            nal, planes, mctx, motion = self._encode_frame(
                self._source(frames[poc - start_poc]), cvs_poc, slice_type,
                (refs_l0, refs_l1), deltas, qp, timing, spans)
            if rc is not None:
                rc.update_after_picture(len(nal) * 8)
            out += nal
            recons[poc] = planes
            if on_frame is not None:
                on_frame(poc, is_idr, bytes(nal))
            dpb[cvs_poc] = RefPic(planes, cvs_poc, motion,
                                  mctx.l0_pocs if mctx else (),
                                  mctx.l1_pocs if mctx else ())
        timing["wall_s"] = time.perf_counter() - t0
        self.timing = timing
        self.spans = spans
        return bytes(out), [recons[start_poc + i] for i in range(len(frames))]

    def _gop_schedule(self, order, start_poc: int) -> list:
        """The GOP route's dispatch batches of _Picture records: a pre-pass
        resolves every picture's reference lists (encoder.py:561-586), then
        the dependency batcher (:587-646) starts each batch at the earliest
        pending picture and adds later pictures of its slice type and CVS
        whose whole signalled RPS is already dispatched, up to
        inter_batch_cap P or B pictures; an I picture goes alone, and no
        batch reaches past an IDR."""
        sp, cfg = self.sp, self.cfg
        entries = []
        sim_dpb: set = set()
        idr = start_poc
        au = 0
        for poc, slice_type, ref_deltas, qp_off in order:
            is_idr = slice_type == SLICE_I
            if is_idr:
                idr, sim_dpb, au = poc, set(), 0
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
                                    is_idr, idr, au))
            au += 1
            sim_dpb.add(cvs_poc)
        batches = []
        pending = entries
        done: set = set()
        while pending:
            e0 = pending[0]
            taken = [0]
            if e0.st != SLICE_I:
                # read at every batch, as the reference reads it
                cap = inter_batch_cap(sp)
                for k in range(1, len(pending)):
                    if len(taken) >= cap:
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
        return batches

    def _encode_gop_device(self, frames, start_poc, out, order, on_frame):
        """Device route of coding orders with I, P and B slices: the
        counterpart of fasthevc_tpu/codec/encoder.py:518-965.  The batches
        of _gop_schedule (in low-delay P each picture references its
        predecessor, so batches hold one; a random-access GOP-16 below
        1280x720 goes as [16] [8] [4, 12] [2, 6, 10, 14] [the odd POCs],
        and the stream holds its pictures in that batch order, as the
        reference's device route writes them): I pictures through
        encode_group_device, P and B batches through
        encode_inter_group_device, two batches in flight.  Under rate
        control the batches run one after another: each picture's QP is
        the controller's, assigned before its batch is dispatched (so a
        batch gets no feedback from its own pictures), the CNN's qp
        feature the batch's first picture's, and the controller sees every
        picture's bits in batch order (:893-928).  References live in a
        DPB of uint8 recon planes on the device, each evicted after the
        last batch that reads it; the host keeps each picture's motion for
        TMVP and emits CABAC on a thread pool, with HRD's buffering period
        at each IDR and each picture's timing by its coding-order AU index
        in its CVS (:862-871).  timing: device_s, wait_s, entropy_s,
        wall_s."""
        sp = self.sp
        cfg = self.cfg
        ctu = 1 << sp.log2_ctu
        tbx = tuple(int(b) * ctu for b in sp.tile_col_bounds()[1:-1])
        tby = tuple(int(b) * ctu for b in sp.tile_row_bounds()[1:-1])
        deblock_on = not sp.deblocking_disabled
        sao_on = bool(sp.sao_enabled)
        gh, gw = sp.coded_height >> 3, sp.coded_width >> 3
        cksum_hash = cfg.hash_type == HASH_CHECKSUM
        reorder = hrd_reorder_delay(cfg)
        batches = self._gop_schedule(order, start_poc)
        rc = self._rate_controller()

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
            nal = (self._hrd_sei(e.is_idr, e.au, e.cvs_poc, reorder)
                   + bs.write_nal(nal_type, w.get_bytes()))
            nal += bs.write_nal(bs.NAL_SUFFIX_SEI,
                                write_picture_hash_sei(md5s, cfg.hash_type))
            return nal, planes

        def plan(bi):
            batches[bi] = [e._replace(qp=rc.picture_qp(len(frames),
                                                       is_intra=e.is_idr))
                           for e in batches[bi]]

        results = self._run_batches(
            frames, [[e.poc - start_poc for e in b] for b in batches],
            run_batch, emit_frame, "device_s", "entropy_s", on_fetch, rc=rc,
            plan=plan)
        recons: dict = {}
        for e, (nal_bytes, planes) in zip(
                [e for b in batches for e in b], results):
            out += nal_bytes
            recons[e.poc] = planes
            if on_frame is not None:
                on_frame(e.poc, e.is_idr, bytes(nal_bytes))
        return bytes(out), [recons[start_poc + i] for i in range(len(frames))]
