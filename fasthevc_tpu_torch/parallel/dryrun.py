"""The multi-device dry run: twin of __graft_entry__.dryrun_multichip.

`dryrun_multichip(n_ranks, device)` builds the ("gop", "tile") mesh of
n_ranks in-process ranks and encodes the reference's two configurations
through the sharded drivers, each held byte for byte against TorchEncoder's
single-device route with the same tile columns and decoded with matching
hashes:
  * all-intra, (64 * n_tile) x 64, one frame per gop row, SAO on (the
    SAO halo);
  * IDR + P segments of two frames per gop row, SR 8 (ME halo 64), SAO
    and RDOQ off, one reference per list, no TMVP.

    python -m fasthevc_tpu_torch.parallel.dryrun [--ranks 8] [--cpu]

runs it in process; with --dist-rank R --init tcp://localhost:PORT --out
FILE it runs the all-intra case as rank R of a process mesh over
torch.distributed (gloo with --cpu, NCCL on one card per rank), and rank 0
writes the stream to FILE and holds it against the single-device route
and a hash-checked decode.
"""

from __future__ import annotations

import sys

import torch

from ..codec.encoder import TorchEncoder
from ..config import EncoderConfig, GopEntry
from ..spec.decoder import SpecDecoder
from ..utils import synthesize_yuv
from .group import DistGroup
from .mesh import gop_tile_mesh
from .sharded import sharded_encode_all_intra, sharded_encode_gop


def dryrun_configs(n_tile: int, n_gop: int) -> list:
    """The two (name, cfg, clip, driver) cases of the dry run."""
    w = 64 * n_tile
    clip1 = synthesize_yuv(w, 64, n_gop, seed=1)
    cfg1 = EncoderConfig(width=w, height=64, qp=32, frames=n_gop,
                         tile_cols=n_tile, tile_rows=1, sao=True)
    seg = 2
    clip2 = synthesize_yuv(w, 64, seg * n_gop, seed=2)
    cfg2 = EncoderConfig(width=w, height=64, qp=32, frames=seg * n_gop,
                         tile_cols=n_tile, tile_rows=1, sao=False,
                         rdoq=False, intra_period=seg,
                         gop=[GopEntry(1, 0, "P", (-1,))], search_range=8,
                         num_ref_per_list=1, temporal_mvp=False)
    return [("intra_sao", cfg1, clip1, sharded_encode_all_intra),
            ("idr_p", cfg2, clip2, sharded_encode_gop)]


def dryrun_multichip(n_ranks: int = 8, device="cuda",
                     plain: bool = False) -> dict:
    """Run both cases on an in-process mesh of n_ranks on `device` (the
    kernels, or with `plain` their twins); raises AssertionError where a
    sharded stream differs from the single-device one or a hash fails.
    Returns {case: stream}."""
    mesh = gop_tile_mesh(n_ranks, device=device)
    n_tile, n_gop = mesh.shape["tile"], mesh.shape["gop"]
    streams = {}
    for name, cfg, clip, driver in dryrun_configs(n_tile, n_gop):
        stream, _ = driver(clip, cfg, mesh, plain=plain)
        single, _ = TorchEncoder(cfg, device=device, plain=plain).encode(clip)
        assert stream == single, (
            f"{name}: sharded {len(stream)}B != single-device "
            f"{len(single)}B")
        pics = SpecDecoder().decode(stream)
        assert len(pics) == len(clip) and all(p.hash_ok for p in pics), (
            f"{name}: decode hash mismatch")
        print(f"dryrun_multichip {name} OK: mesh={mesh.shape} "
              f"{cfg.width}x{cfg.height}, sharded == single "
              f"({len(stream)} bytes), decode hash OK")
        streams[name] = stream
    return streams


def dryrun_dist(rank: int, n_ranks: int, init_method: str, out: str,
                device="cuda") -> None:
    """The all-intra case as rank `rank` of n_ranks processes
    (`DistGroup`); rank 0 writes the stream to `out`, then raises
    AssertionError unless it equals TorchEncoder's single-device stream
    (on rank 0's device) and decodes hash-clean."""
    n_tile = 4 if n_ranks % 4 == 0 else (2 if n_ranks % 2 == 0 else 1)
    dev = (f"cuda:{rank % max(1, torch.cuda.device_count())}"
           if str(device) == "cuda" else device)
    group = DistGroup(rank, n_ranks // n_tile, n_tile, dev,
                      init_method=init_method)
    try:
        mesh = gop_tile_mesh(n_ranks, n_tile, device=device, transport=group)
        _, cfg, clip, driver = dryrun_configs(n_tile, n_ranks // n_tile)[0]
        stream, _ = driver(clip, cfg, mesh)
        if rank == 0:
            with open(out, "wb") as f:
                f.write(stream)
        group.barrier()
    finally:
        group.close()
    if rank == 0:
        single, _ = TorchEncoder(cfg, device=dev).encode(clip)
        assert stream == single, (f"process mesh {len(stream)}B != "
                                  f"single-device {len(single)}B")
        pics = SpecDecoder().decode(stream)
        assert all(p.hash_ok for p in pics), "decode hash mismatch"
        print(f"dryrun_dist OK: {n_ranks} processes over "
              f"{'gloo' if str(device) == 'cpu' else 'NCCL'}, sharded == "
              f"single ({len(stream)} bytes), decode hash OK")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' twins on the CPU")
    ap.add_argument("--dist-rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.dist_rank is None:
        dryrun_multichip(args.ranks, device)
    else:
        dryrun_dist(args.dist_rank, args.ranks, args.init, args.out, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
