"""Rank groups: the port's stand-in for shard_map's axis collectives.

A mesh (`mesh.Mesh`) is a ("gop", "tile") grid of ranks, rank = g * n_tile
+ t.  One per-rank program runs under either transport and calls, on the
group it is handed:
  * `axis_index(name)`: its coordinate on the "gop" or "tile" axis
    (`jax.lax.axis_index`);
  * `halo(planes, wl, wr)`: the pair of `ppermute`s along the tile axis of
    fasthevc_tpu/parallel/sharded.py `_ppermute_halo`, returning the
    planes extended by the left neighbour's last wl and the right
    neighbour's first wr columns, edge-replicated at the picture bounds
    (kernel K16, ops/halo.py); `own=False` returns the halo columns
    alone; `cyclic=True` wraps the tile axis around instead, as
    parallel/mesh.py's right-strip exchange does;
  * `all_reduce_sum(x)`: `psum` over both axes, summed in rank order;
  * `all_gather(x)`: every rank's x, in rank order;
  * `barrier()`.

Two transports:
  * `ThreadGroup`: every rank of the mesh in this process, one Python
    thread and one CUDA stream each; rank r runs on its mesh device (on a
    one-card host all ranks share the card).  A rank publishes the tensors
    of a collective with an event recorded on its stream; a reader's stream
    waits on that event before K16 reads them, and marks them used on its
    stream (`record_stream`), so the caching allocator keeps them until
    the reader's kernels are done.  Two host barriers bracket each
    collective.
  * `DistGroup`: torch.distributed, one process per rank: halos travel as
    K16's packed send buffers through `batch_isend_irecv`, sums through
    `all_reduce`.  NCCL carries CUDA tensors (one card per rank), gloo CPU
    tensors; gloo refuses CUDA tensors rather than staging them through
    the host.
"""

from __future__ import annotations

import threading
import time

import torch

from ..ops.halo import halo_extend, halo_pack, halo_strips

AXES = ("gop", "tile")


class _Coords:
    """A rank's place in the ("gop", "tile") grid."""

    def __init__(self, rank: int, n_gop: int, n_tile: int) -> None:
        self.rank = rank
        self.n_gop = n_gop
        self.n_tile = n_tile
        self.size = n_gop * n_tile

    def axis_index(self, name: str) -> int:
        if name == "gop":
            return self.rank // self.n_tile
        if name == "tile":
            return self.rank % self.n_tile
        raise ValueError(f"unknown mesh axis {name!r}; axes are {AXES}")

    def axis_size(self, name: str) -> int:
        return {"gop": self.n_gop, "tile": self.n_tile}[name]

    def _neighbours(self, cyclic: bool) -> tuple:
        """Ranks to the left and right on the tile axis (None at a picture
        bound unless cyclic)."""
        t = self.axis_index("tile")
        base = self.rank - t
        if cyclic:
            return (base + (t - 1) % self.n_tile,
                    base + (t + 1) % self.n_tile)
        return (self.rank - 1 if t > 0 else None,
                self.rank + 1 if t < self.n_tile - 1 else None)


class _Hub:
    """What the ranks of one in-process mesh share during a run."""

    def __init__(self, size: int) -> None:
        self.barrier = threading.Barrier(size)
        self.slots: dict = {}


class ThreadGroup(_Coords):
    """One rank of an in-process mesh (see the module docstring)."""

    def __init__(self, hub: _Hub, rank: int, n_gop: int, n_tile: int,
                 device, stream=None) -> None:
        super().__init__(rank, n_gop, n_tile)
        self.hub = hub
        self.device = torch.device(device)
        self.stream = stream
        self.seq = 0
        self.wait_s = 0.0      # host seconds blocked in the barriers

    def _wait(self) -> None:
        t0 = time.perf_counter()
        self.hub.barrier.wait()
        self.wait_s += time.perf_counter() - t0

    def _publish(self, tensors: list) -> None:
        self.seq += 1
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        self.hub.slots[(self.seq, self.rank)] = (tensors, event)
        self._wait()

    def _read(self, rank) -> list | None:
        if rank is None:
            return None
        tensors, event = self.hub.slots[(self.seq, rank)]
        if rank != self.rank and self.stream is not None:
            if event is not None:
                self.stream.wait_event(event)
            for t in tensors:
                if t.is_cuda:
                    t.record_stream(self.stream)
        return tensors

    def _done(self) -> None:
        self._wait()
        del self.hub.slots[(self.seq, self.rank)]

    def halo(self, planes, wl, wr, cyclic: bool = False,
             own: bool = True) -> list:
        planes = [p.contiguous() for p in planes]
        self._publish(planes)
        left, right = self._neighbours(cyclic)
        lefts = self._read(left) or [None] * len(planes)
        rights = self._read(right) or [None] * len(planes)
        out = halo_extend(planes, lefts, rights, wl, wr, own=own)
        self._done()
        return out

    def all_gather(self, x: torch.Tensor) -> list:
        self._publish([x])
        out = [self._read(r)[0].to(self.device) for r in range(self.size)]
        self._done()
        return out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        total = None
        for v in self.all_gather(x):
            total = v.clone() if total is None else total + v
        return total

    def barrier(self) -> None:
        self._wait()


def run_threads(mesh, fn, args_of) -> dict:
    """Run fn(group, *args_of(rank)) for every rank of the in-process mesh,
    each in its own thread (and CUDA stream); returns {rank: result}.  The
    caller's stream waits for every rank's work before this returns.  A
    rank that raises breaks the barriers of the others, and the first
    error is raised here.  Each rank's host seconds are added to
    mesh.rank_times[rank]: wall_s (its program), cpu_s (its thread's CPU
    time) and wait_s (blocked in the barriers); the rest of wall_s is time
    the thread was ready but held off the CPU, by the GIL or a blocking
    call."""
    hub = _Hub(mesh.size)
    results: dict = {}
    errors: list = []
    caller = {}
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            caller[dev] = torch.cuda.current_stream(dev)
    args = {r: args_of(r) for r in range(mesh.size)}
    done_events: list = []

    def body(rank: int) -> None:
        dev = mesh.devices[rank]
        stream = mesh.stream(rank)
        t0, c0 = time.perf_counter(), time.thread_time()
        group = None
        try:
            group = ThreadGroup(hub, rank, mesh.shape["gop"],
                                mesh.shape["tile"], dev, stream)
            if stream is None:
                results[rank] = fn(group, *args[rank])
                return
            stream.wait_stream(caller[dev])
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                results[rank] = fn(group, *args[rank])
                event = torch.cuda.Event()
                event.record(stream)
                done_events.append((dev, event))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            hub.barrier.abort()
        finally:
            times = mesh.rank_times.setdefault(
                rank, {"wall_s": 0.0, "cpu_s": 0.0, "wait_s": 0.0})
            times["wall_s"] += time.perf_counter() - t0
            times["cpu_s"] += time.thread_time() - c0
            times["wait_s"] += 0.0 if group is None else group.wait_s

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(mesh.size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    for dev, event in done_events:
        caller[dev].wait_event(event)
    return results


class DistGroup(_Coords):
    """This process's rank of a mesh over torch.distributed (see the module
    docstring).  The process group is initialised here unless it already
    is: init_method e.g. "tcp://localhost:<port>", backend "nccl" when
    every rank owns a card, "gloo" on CPU tensors."""

    def __init__(self, rank: int, n_gop: int, n_tile: int, device,
                 init_method: str | None = None,
                 backend: str | None = None) -> None:
        import torch.distributed as dist

        super().__init__(rank, n_gop, n_tile)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the kernels launch on the current device's context
            torch.cuda.set_device(self.device)
        if not dist.is_initialized():
            if backend is None:
                backend = "nccl" if self.device.type == "cuda" else "gloo"
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=self.size)
        self.dist = dist
        self.backend = dist.get_backend()

    def _check(self, tensors) -> None:
        if self.backend == "gloo" and any(t.is_cuda for t in tensors):
            raise ValueError("DistGroup over gloo carries CPU tensors only: "
                             "run one card per rank over NCCL, or the "
                             "in-process ThreadGroup")

    def halo(self, planes, wl, wr, cyclic: bool = False,
             own: bool = True) -> list:
        planes = [p.contiguous() for p in planes]
        self._check(planes)
        left, right = self._neighbours(cyclic)
        to_left, to_right = halo_pack(planes, wl, wr)
        # what a neighbour sends this way has the layout of what this rank
        # sends the other way: the left strip arrives as the left
        # neighbour's to_right
        recv = {side: torch.empty_like(to_right if side == "l" else to_left)
                for side, peer in (("l", left), ("r", right))
                if peer is not None}
        sends, recvs = [], []
        for side, peer, send in (("l", left, to_left), ("r", right, to_right)):
            if peer is None:
                continue
            if peer == self.rank:     # one tile, cyclic: its own strips
                recv["r" if side == "l" else "l"].copy_(send)
                continue
            sends.append(self.dist.P2POp(self.dist.isend, send, peer))
        for side, peer in (("r", right), ("l", left)):
            if peer is not None and peer != self.rank:
                recvs.append(self.dist.P2POp(self.dist.irecv, recv[side],
                                             peer))
        # sends leftward first and receives from the right first, so that
        # two tiles on a cyclic axis (one peer on both sides) match in order
        if sends or recvs:
            for req in self.dist.batch_isend_irecv(sends + recvs):
                req.wait()
        n = len(planes)
        lefts = (halo_strips(recv["l"], planes, wl) if "l" in recv
                 else [None] * n)
        rights = (halo_strips(recv["r"], planes, wr) if "r" in recv
                  else [None] * n)
        return halo_extend(planes, lefts, rights, wl, wr, own=own)

    def all_gather(self, x: torch.Tensor) -> list:
        x = x.contiguous()
        self._check([x])
        # as bytes: gloo reduces and gathers only some element types
        raw = x.view(torch.uint8).reshape(-1)
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        self.dist.all_gather(parts, raw)
        return [p.view(x.dtype).reshape(x.shape) for p in parts]

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        self._check([x])
        total = x.clone()
        self.dist.all_reduce(total)
        return total

    def barrier(self) -> None:
        self.dist.barrier()

    def close(self) -> None:
        if self.dist.is_initialized():
            self.dist.destroy_process_group()
