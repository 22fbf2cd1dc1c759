"""The ("gop", "tile") mesh of ranks and the sharded frame-search step.

Counterpart of fasthevc_tpu/parallel/mesh.py.  A mesh is a grid of ranks:
"gop" is data-parallel over frames (GOP-parallel), "tile" splits each
frame into CTU-aligned tile columns whose boundary strips the ranks
exchange (`group.halo`).  Rank = g * n_tile + t.  The mesh runs its ranks
either in this process (`group.ThreadGroup`, one thread and one CUDA
stream per rank, all ranks of a one-card host on that card) or one rank
per process over torch.distributed (`group.DistGroup`, given as
`transport`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.search import search_intra_frames
from .group import DistGroup, run_threads


class Mesh:
    """A ("gop", "tile") grid of ranks and the device of each.

    transport None runs every rank in this process; a DistGroup makes this
    process that group's rank alone.  `run(fn, args_of)` calls
    fn(group, *args_of(rank)) for the ranks this process runs and returns
    {rank: result}; `to_host(results)` brings every rank's result (a dict
    of tensors) to the host as numpy, in rank order."""

    def __init__(self, n_gop: int, n_tile: int, devices,
                 transport: DistGroup | None = None) -> None:
        self.shape = {"gop": n_gop, "tile": n_tile}
        self.size = n_gop * n_tile
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(f"{self.size} ranks need {self.size} devices")
        self.transport = transport
        self._streams: dict = {}
        # host seconds of each in-process rank, summed over runs
        # (group.run_threads)
        self.rank_times: dict = {}

    def stream(self, rank: int):
        """Rank's own CUDA stream (in-process, on a card), else None."""
        dev = self.devices[rank]
        if dev.type != "cuda":
            return None
        if rank not in self._streams:
            self._streams[rank] = torch.cuda.Stream(dev)
        return self._streams[rank]

    def run(self, fn, args_of) -> dict:
        if self.transport is None:
            return run_threads(self, fn, args_of)
        rank = self.transport.rank
        return {rank: fn(self.transport, *args_of(rank))}

    def to_host(self, results: dict) -> list:
        """[{key: numpy}] of every rank's result dict, in rank order."""
        if self.transport is None:
            return [{k: v.cpu().numpy() for k, v in results[r].items()}
                    for r in range(self.size)]
        mine = results[self.transport.rank]
        out = [{} for _ in range(self.size)]
        for k in sorted(mine):
            for r, v in enumerate(self.transport.all_gather(mine[k])):
                out[r][k] = v.cpu().numpy()
        return out


def gop_tile_mesh(n_devices: int | None = None, n_tile: int | None = None,
                  device="cuda", transport: DistGroup | None = None) -> Mesh:
    """The ("gop", "tile") grid of n_devices ranks (mesh.py:24-35): n_tile
    4 when n divides by 4, else 2 when n is even, else 1.  Rank r runs on
    cuda:(r % device_count()) for device "cuda" (so on a one-card host
    every rank shares the card), else on `device`.  n_devices defaults to
    the number of cards (1 on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("gop_tile_mesh: no CUDA device; pass "
                               "device='cpu' for the plain twins")
        n = n_devices or count
        devices = [torch.device("cuda", r % count) for r in range(n)]
    else:
        n = n_devices or 1
        devices = [device] * n
    if n_tile is None:
        n_tile = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if n % n_tile:
        raise ValueError(f"{n} ranks do not split into tile rows of {n_tile}")
    return Mesh(n // n_tile, n_tile, devices, transport)


def sharded_search_step(mesh: Mesh, log2_ctu: int = 5, log2_min_cu: int = 3,
                        halo: int = 4):
    """The sharded intra search step (mesh.py:38-85): step(frames,
    lambda_sqrt) with frames [G, H, W] int (G divisible by the gop axis, W
    by the tile axis).  Each (gop, tile) rank searches its tile column of
    its frames, sends its rightmost `halo` columns to its right neighbour
    (cyclic along the tile axis, as the reference's ppermute), and the
    ranks sum the top-size RD costs and the boundary statistic
    sum |first column - received last column| over both axes.

    Returns (splits [G, B] bool, each tile's top-size split decisions in
    block raster order, tiles side by side; total cost; boundary), the two
    sums as 0-dim tensors on the host."""
    n_gop, n_tile = mesh.shape["gop"], mesh.shape["tile"]
    top = 1 << log2_ctu

    def per_rank(group, frames, lambda_sqrt):
        dec = search_intra_frames(frames.to(torch.int32), lambda_sqrt,
                                  log2_ctu, log2_min_cu)
        splits, costs = dec[f"split{top}"], dec[f"cost{top}"]
        recv = group.halo([frames], halo, 0, cyclic=True, own=False)[0]
        boundary = (frames[:, :, :1].to(torch.int64)
                    - recv[:, :, -1:].to(torch.int64)).abs().sum()
        total = group.all_reduce_sum(costs.sum().reshape(1))
        bsum = group.all_reduce_sum(boundary.reshape(1))
        return {"splits": splits, "total": total, "boundary": bsum}

    def step(frames, lambda_sqrt):
        frames = torch.as_tensor(np.asarray(frames))
        g, _, w = frames.shape
        gl, wt = g // n_gop, w // n_tile
        if gl * n_gop != g or wt * n_tile != w:
            raise ValueError("frames must split evenly over the mesh")

        def args_of(rank):
            gi, ti = divmod(rank, n_tile)
            part = frames[gi * gl:(gi + 1) * gl, :, ti * wt:(ti + 1) * wt]
            return (part.contiguous().to(mesh.devices[rank]), lambda_sqrt)

        host = mesh.to_host(mesh.run(per_rank, args_of))
        splits = np.concatenate(
            [np.concatenate([host[gi * n_tile + t]["splits"]
                             for t in range(n_tile)], axis=1)
             for gi in range(n_gop)], axis=0)
        return (splits, torch.as_tensor(host[0]["total"][0]),
                torch.as_tensor(host[0]["boundary"][0]))

    return step
