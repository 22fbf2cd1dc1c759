"""GOP-parallel encode across processes (BASELINE config 5's skeleton).

Counterpart of fasthevc_tpu/parallel/multiproc.py.  Each process encodes a
contiguous span of CLOSED GOPs (IDR-led segments are independent) with
`TorchEncoder`, on the card unless device="cpu"; rank 0 writes the
parameter sets, and the parts concatenated in rank order reproduce the
one-process stream byte for byte.  The processes meet at a barrier of a
gloo group over a loopback TCP store (the reference uses
jax.distributed); gloo carries nothing else, so several processes may
share one card, each with its own context.

    python -m fasthevc_tpu_torch.parallel.multiproc --rank R --nprocs N \\
        --init tcp://localhost:PORT --cfg cfg.pkl --clip clip.npz \\
        --out part.bin [--device cpu]
runs one worker; `gop_parallel_encode_check` starts them and checks the
result.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _gop_spans(n_frames: int, intra_period: int, n_procs: int):
    """Split [0, n_frames) into n_procs spans aligned to closed-GOP (IDR)
    boundaries."""
    if intra_period <= 0:
        bounds = [0, n_frames]          # one CVS: cannot split safely
    else:
        idrs = list(range(0, n_frames, max(1, intra_period)))
        bounds = idrs + [n_frames]
    # assign consecutive GOP segments to processes as evenly as possible
    segs = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    per = -(-len(segs) // n_procs)
    spans = []
    for p in range(n_procs):
        chunk = segs[p * per:(p + 1) * per]
        if chunk:
            spans.append((chunk[0][0], chunk[-1][1]))
        else:
            spans.append((n_frames, n_frames))
    return spans


def _worker(rank: int, n_procs: int, init_method: str, cfg_blob: str,
            clip_path: str, out_path: str, device: str) -> None:
    import numpy as np
    import torch.distributed as dist

    from ..codec.encoder import TorchEncoder

    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=n_procs)
    try:
        with open(cfg_blob, "rb") as f:
            cfg = pickle.load(f)
        clip = np.load(clip_path, allow_pickle=True)
        frames = [tuple(fr) for fr in clip["frames"]]
        spans = _gop_spans(len(frames), 1 if cfg.intra_period == 1
                           else cfg.intra_period, n_procs)
        lo, hi = spans[rank]
        stream = b""
        if hi > lo:
            enc = TorchEncoder(cfg, device=device)
            stream, _ = enc.encode(frames[lo:hi], start_poc=lo,
                                   write_headers=(rank == 0))
        with open(out_path, "wb") as f:
            f.write(stream)
        # the parent concatenates when every part exists
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(rank: int, n_procs: int, cfg_blob: str, clip_path: str,
           out_path: str, device: str, init_method: str):
    return subprocess.Popen(
        [sys.executable, "-m", "fasthevc_tpu_torch.parallel.multiproc",
         "--rank", str(rank), "--nprocs", str(n_procs), "--init",
         init_method, "--cfg", cfg_blob, "--clip", clip_path, "--out",
         out_path, "--device", device], cwd=_ROOT)


def _run(n_procs: int, cfg_blob: str, clip_path: str, outs: list,
         device: str, timeout: float) -> tuple:
    """Start n_procs workers, wait for them; (return codes, seconds)."""
    t0 = time.perf_counter()
    init = f"tcp://localhost:{_free_port()}"
    procs = [_spawn(r, n_procs, cfg_blob, clip_path, outs[r], device, init)
             for r in range(n_procs)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, time.perf_counter() - t0


def _read(path: str) -> bytes:
    """A worker's output, or nothing where the worker wrote none."""
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def gop_parallel_encode_check(width: int, height: int, n_frames: int,
                              n_procs: int = 2, tile_cols: int = 1,
                              tile_rows: int = 1, qp: int = 32,
                              intra_period: int = 8, inter: bool = True,
                              device: str = "cuda",
                              timeout: float = 900, decode: bool = True,
                              keep: str | None = None) -> dict:
    """Run the n_procs-process GOP-parallel encode and check that the
    concatenated stream equals a one-process encode byte for byte and
    decodes with matching hashes (multiproc.py:71).  inter: closed GOPs of
    low-delay P pictures (the reference's four-entry GOP) inside
    intra_period-led segments; else all pictures IDR.  decode=False leaves
    the decode out (`ok` then needs the bytes alone); keep: a path to
    write the stream to.  Returns a dict with `ok`, the byte counts, the
    return codes, and the wall seconds of both runs (process start
    included)."""
    import numpy as np

    from ..config import EncoderConfig, GopEntry
    from ..spec.decoder import SpecDecoder
    from ..utils import synthesize_yuv

    clip = synthesize_yuv(width, height, n_frames, seed=5)
    if inter:
        gop = [GopEntry(1, 2, "P", (-1,)), GopEntry(2, 1, "P", (-1, -2)),
               GopEntry(3, 2, "P", (-1,)), GopEntry(4, 0, "P", (-1, -2))]
        cfg = EncoderConfig(width=width, height=height, qp=qp,
                            frames=n_frames, intra_period=intra_period,
                            gop=gop, tile_cols=tile_cols,
                            tile_rows=tile_rows)
    else:
        cfg = EncoderConfig(width=width, height=height, qp=qp,
                            frames=n_frames, intra_period=1,
                            tile_cols=tile_cols, tile_rows=tile_rows)
    with tempfile.TemporaryDirectory(prefix="fasthevc_torch_mp_") as tmp:
        cfg_blob = os.path.join(tmp, "cfg.pkl")
        clip_path = os.path.join(tmp, "clip.npz")
        with open(cfg_blob, "wb") as f:
            pickle.dump(cfg, f)
        np.savez(clip_path, frames=np.asarray(clip, dtype=object))
        outs = [os.path.join(tmp, f"part{r}.bin") for r in range(n_procs)]
        rcs, par_s = _run(n_procs, cfg_blob, clip_path, outs, device,
                          timeout)
        ref_path = os.path.join(tmp, "single.bin")
        rc1, single_s = _run(1, cfg_blob, clip_path, [ref_path], device,
                             timeout)
        rcs += rc1
        stream = b"".join(_read(o) for o in outs)
        single = _read(ref_path)
    ok_bytes = bool(stream) and stream == single
    if keep is not None:
        with open(keep, "wb") as f:
            f.write(stream)
    ok_hash = not decode
    if ok_bytes and decode:
        pics = SpecDecoder().decode(stream)
        ok_hash = all(p.hash_ok for p in pics) and len(pics) == n_frames
    return {"config": "gop-parallel-multiproc", "n_procs": n_procs,
            "device": device, "rcs": rcs, "bytes": len(stream),
            "single_bytes": len(single), "byte_identical": bool(ok_bytes),
            "decode_verify": bool(ok_hash) if decode else None,
            "parallel_s": par_s,
            "single_s": single_s,
            "ok": bool(ok_bytes and ok_hash and all(rc == 0 for rc in rcs))}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--clip", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _worker(args.rank, args.nprocs, args.init, args.cfg, args.clip,
            args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
