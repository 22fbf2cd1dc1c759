"""fasthevc_tpu_torch's multi-device layer against the reference and the
single-device route.

Components, against fasthevc_tpu/parallel/sharded.py under a shard_map on
conftest's virtual CPU devices: K16's twin (`halo_extend`) against
`_ppermute_halo`, K6's tile-column twin against `_deblock_sharded_cols`,
K7's halo twin against `sao_device(has_halo=True)`, and the searches'
picture edge (`mpm_edge_x`) against `search_intra_frame`.  Then the
sharded drivers on in-process meshes (`ThreadGroup`) and across two gloo
processes (`DistGroup`): their streams equal TorchEncoder's single-device
route on the same tile grid and decode with matching hashes, and the
halos are load-bearing.  The slow tier holds the streams against the JAX
package's sharded drivers and dry run.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from fasthevc_tpu.codec.search import search_intra_frame as jax_search_intra
from fasthevc_tpu.ops.deblock import inter_bs_maps as jax_bs_maps
from fasthevc_tpu.ops.deblock import tu_cbf_map as jax_cbf_map
from fasthevc_tpu.ops.sao import sao_device
from fasthevc_tpu.parallel import mesh as jax_mesh
from fasthevc_tpu.parallel import sharded as jax_sharded
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.codec.search import search_intra_frame
from fasthevc_tpu_torch.config import EncoderConfig, GopEntry
from fasthevc_tpu_torch.ops import deblock as port_deblock
from fasthevc_tpu_torch.ops.halo import (halo_extend, halo_pack, halo_strips)
from fasthevc_tpu_torch.ops.sao import sao
from fasthevc_tpu_torch.parallel import gop_tile_mesh, sharded_search_step
from fasthevc_tpu_torch.parallel import group as port_group
from fasthevc_tpu_torch.parallel import sharded
from fasthevc_tpu_torch.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def device_route(monkeypatch):
    """The sharded commit is the device commit: hold it against the device
    route, not the classic one conftest selects."""
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)


def _jax_mesh(n_tile):
    devs = np.array(jax.devices()[:n_tile]).reshape(1, n_tile)
    return JaxMesh(devs, axis_names=("gop", "tile"))


def _run_ranks(mesh, fn, args_of):
    return [v for _, v in sorted(mesh.run(fn, args_of).items())]


def _tiles(a, n, axis=-1):
    return np.split(np.asarray(a), n, axis=axis)


def _random_depth(gh, gw, rng):
    depth = np.zeros((gh, gw), np.int32)
    for cy in range(0, gh, 4):
        for cx in range(0, gw, 4):
            if rng.random() < 0.7:
                for sy in range(2):
                    for sx in range(2):
                        depth[cy + 2 * sy:cy + 2 * sy + 2,
                              cx + 2 * sx:cx + 2 * sx + 2] = \
                            1 + (rng.random() < 0.5)
    return depth


# ---------------------------------------------------------------------------
# K16: the halo exchange
# ---------------------------------------------------------------------------

def test_halo_twin_matches_ppermute_halo():
    """Interior and edge ranks of a 4-tile row, planes of three element
    types and halo widths, exactly as the reference's ppermute pair."""
    rng = np.random.default_rng(0)
    n = 4
    cases = [(rng.integers(0, 256, (2, 16, 4 * 32)).astype(np.uint8), 8, 16),
             (rng.integers(-99, 99, (3, 4 * 12)).astype(np.int32), 1, 1),
             (rng.integers(-9, 9, (5, 4 * 16)).astype(np.int16), 4, 4)]
    jm = _jax_mesh(n)
    mesh = gop_tile_mesh(n, n_tile=n, device="cpu")
    for x, wl, wr in cases:
        spec = P(*([None] * (x.ndim - 1) + ["tile"]))

        def ref(t, wl=wl, wr=wr):
            lt, rt = jax_sharded._ppermute_halo(t, "tile", n, wl, wr)
            return jnp.concatenate([lt, t, rt], axis=-1)

        want = _tiles(jax.jit(shard_map(ref, mesh=jm, in_specs=spec,
                                        out_specs=spec))(jnp.asarray(x)), n)
        parts = _tiles(x, n)
        got = _run_ranks(mesh, lambda g, p: g.halo([p], wl, wr)[0],
                         lambda r: (torch.from_numpy(parts[r].copy()),))
        for r in range(n):
            assert np.array_equal(got[r].numpy(), want[r]), (x.dtype, r)
        # the halos alone: the same columns without the shard's own
        got = _run_ranks(mesh,
                         lambda g, p: g.halo([p], wl, wr, own=False)[0],
                         lambda r: (torch.from_numpy(parts[r].copy()),))
        for r in range(n):
            want_halo = np.concatenate([want[r][..., :wl],
                                        want[r][..., -wr:]], axis=-1)
            assert np.array_equal(got[r].numpy(), want_halo), (x.dtype, r)


def test_halo_pack_and_strips_assemble_the_same_planes():
    """The process transport's layout: the strips read back from the
    neighbours' packed buffers extend the planes as the neighbours' whole
    planes do."""
    rng = np.random.default_rng(1)
    planes = [torch.from_numpy(rng.integers(0, 256, (1, 8, 24))
                               .astype(np.uint8)),
              torch.from_numpy(rng.integers(-5, 5, (1, 8, 12))
                               .astype(np.int32)),
              torch.from_numpy(rng.integers(-5, 5, (2, 12))
                               .astype(np.int16))]
    left = [p + 1 for p in planes]
    right = [p + 2 for p in planes]
    wl, wr = [4, 2, 1], [8, 4, 2]
    want = halo_extend(planes, left, right, wl, wr)
    _, from_left = halo_pack(left, wl, wr)
    from_right, _ = halo_pack(right, wl, wr)
    got = halo_extend(planes, halo_strips(from_left, planes, wl),
                      halo_strips(from_right, planes, wr), wl, wr)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K6's tile-column form
# ---------------------------------------------------------------------------

def _deblock_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    gh, gw = h // 8, w // 8
    depth = _random_depth(gh, gw, rng)
    y = rng.integers(60, 200, (h, w)).astype(np.int32)
    cb = rng.integers(60, 200, (h // 2, w // 2)).astype(np.int32)
    cr = rng.integers(60, 200, (h // 2, w // 2)).astype(np.int32)
    dir_map = rng.integers(0, 4, (gh, gw)).astype(np.int32)
    mv = rng.integers(-12, 12, (gh, gw, 4)).astype(np.int32)
    lv = (rng.random((h, w)) < 0.01).astype(np.int32) * 3
    return y, cb, cr, depth, dir_map, mv, lv


@pytest.mark.parametrize("inter", [False, True], ids=["intra_bs", "p_maps"])
def test_deblock_window_twin_matches_sharded_cols(inter):
    """Two tiles of a 64x128 picture: the reference's cross-tile deblock
    (its P strengths from the halo-extended maps, sharded.py:433-451)
    against K6's tile-column twin on the port's K16 halos; both equal the
    whole-picture deblock."""
    h, w, n = 64, 128, 2
    qp, qc = 37, 36
    y, cb, cr, depth, dir_map, mv, lv = _deblock_inputs(3 + inter, h, w)
    jm = _jax_mesh(n)
    sp = P(None, "tile")

    def ref(ry, rcb, rcr, dm, im, mvf, lvy):
        kw = {}
        if inter:
            gh, gt = dm.shape
            cbf = jax_cbf_map(lvy, dm, 5)
            mv3 = mvf.reshape(gh, gt, 4)
            cl, crh = jax_sharded._ppermute_halo(cbf.astype(jnp.int32),
                                                 "tile", n, 1, 1)
            il, ir = jax_sharded._ppermute_halo(im, "tile", n, 1, 1)
            ml, mr = jax_sharded._ppermute_halo(mvf, "tile", n, 4, 4)
            dl, dr = jax_sharded._ppermute_halo(dm, "tile", n, 1, 1)
            bs_v_e, _ = jax_bs_maps(
                jnp.concatenate([dl, dm, dr], 1),
                jnp.concatenate([il, im, ir], 1),
                jnp.concatenate([ml.reshape(gh, 1, 4), mv3,
                                 mr.reshape(gh, 1, 4)], 1),
                jnp.concatenate([cl, cbf.astype(jnp.int32), crh], 1))
            _, bs_h = jax_bs_maps(dm, im, mv3, cbf)
            kw = dict(bs_vert_ext=bs_v_e, bs_horz=bs_h)
        return jax_sharded._deblock_sharded_cols(
            ry, rcb, rcr, dm, qp, qc, qc, "tile", n, **kw)

    # jitted: an eager shard_map dispatches op by op on every device
    want = jax.jit(shard_map(ref, mesh=jm, in_specs=(sp,) * 7,
                             out_specs=(sp, sp, sp), check_rep=False))(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jnp.asarray(depth),
        jnp.asarray(dir_map), jnp.asarray(mv.reshape(h // 8, -1)),
        jnp.asarray(lv))

    mesh = gop_tile_mesh(n, n_tile=n, device="cpu")
    parts = [_tiles(a, n) for a in (y, cb, cr, depth, dir_map, lv)]
    mv_parts = _tiles(mv, n, axis=1)

    def rank(g, ry, rcb, rcr, dm, im, mvt, lvy):
        maps = None
        if inter:
            maps = (im, mvt, port_deblock.tu_cbf(lvy, dm, 5))
        return sharded._deblock_sharded_cols(g, ry, rcb, rcr, dm, qp, qc, qc,
                                             w, inter_maps=maps)

    def args(r):
        return tuple(torch.from_numpy(np.ascontiguousarray(p[r]))[None]
                     for p in parts[:5]) + (
            torch.from_numpy(np.ascontiguousarray(mv_parts[r]))[None],
            torch.from_numpy(np.ascontiguousarray(parts[5][r]))[None])

    got = _run_ranks(mesh, rank, args)
    kw = {}
    if inter:
        kw = dict(dir_map=torch.from_numpy(dir_map)[None],
                  mv_map=torch.from_numpy(mv)[None],
                  cbf=port_deblock.tu_cbf(torch.from_numpy(lv)[None],
                                          torch.from_numpy(depth)[None], 5))
    whole = port_deblock.deblock(
        *(torch.from_numpy(a)[None] for a in (y, cb, cr, depth)), qp, qc,
        qc, 5, **kw)
    for c in range(3):
        joined = np.concatenate([got[r][c][0].numpy() for r in range(n)],
                                axis=-1)
        assert np.array_equal(joined, np.asarray(want[c])), c
        assert np.array_equal(joined, whole[c][0].numpy()), c


# ---------------------------------------------------------------------------
# K7's halo form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,l_av,r_av", [
    (64, False, False), (64, True, False), (64, False, True),
    (64, True, True), (48, True, True)])
def test_sao_halo_twin_matches_sao_device(h, l_av, r_av):
    """A 64-wide tile (48 rows: the CTB-padded estimate) with random
    neighbour columns, parameters and planes exactly as the reference's."""
    rng = np.random.default_rng(h + 2 * l_av + r_av)
    w = 64
    src = [rng.integers(0, 256, (h >> (c > 0), w >> (c > 0)))
           for c in range(3)]
    rec = [np.clip(s + rng.integers(-6, 7, s.shape), 0, 255)
           for s in src]
    cols = [(rng.integers(0, 256, h >> (c > 0)),
             rng.integers(0, 256, h >> (c > 0))) for c in range(3)]
    want = sao_device(*(jnp.asarray(a, jnp.int32) for a in src + rec), 5,
                      has_halo=True,
                      halo_y=tuple(jnp.asarray(c) for c in cols[0]),
                      halo_cb=tuple(jnp.asarray(c) for c in cols[1]),
                      halo_cr=tuple(jnp.asarray(c) for c in cols[2]),
                      l_avail=jnp.bool_(l_av), r_avail=jnp.bool_(r_av))

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32))[None]

    got = sao(*(t(a) for a in src + rec), 5,
              halo_y=tuple(t(c) for c in cols[0]),
              halo_cb=tuple(t(c) for c in cols[1]),
              halo_cr=tuple(t(c) for c in cols[2]), l_avail=l_av,
              r_avail=r_av)
    for k in range(4):
        assert np.array_equal(got[k][0].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# The searches' picture edge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edge_on", [True, False])
def test_intra_search_edge_matches_reference(edge_on):
    """mpm_edge_x=32 on a 64x128 halo-extended source: modes and splits
    equal search_intra_frame's."""
    y = synthesize_yuv(128, 64, 1, seed=9)[0][0].astype(np.int32)
    ls = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    want = jax_search_intra(jnp.asarray(y), jnp.float32(ls), 5, 3,
                            mpm_edge_x=32, mpm_edge_on=jnp.bool_(edge_on))
    got = search_intra_frame(torch.from_numpy(y), ls, 5, 3, mpm_edge_x=32,
                             mpm_edge_on=edge_on)
    for key in want:
        if key.startswith(("mode", "split")):
            assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


# ---------------------------------------------------------------------------
# The mesh step and the sharded drivers
# ---------------------------------------------------------------------------

def test_sharded_search_step_sums_over_the_mesh():
    """Each rank's top-size splits are its tile's search, and the sums over
    the (2, 2) mesh are the tiles' costs and the cyclic boundary statistic."""
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 32, 128)).astype(np.int32)
    ls = 6.0
    mesh = gop_tile_mesh(4, n_tile=2, device="cpu")
    splits, total, boundary = sharded_search_step(mesh)(frames, ls)
    tiles = _tiles(frames, 2)
    decs = [search_intra_frame(torch.from_numpy(tiles[t][g].copy()), ls)
            for g in range(2) for t in range(2)]
    want_splits = np.stack([np.concatenate([decs[2 * g + t]["split32"]
                                            .numpy() for t in range(2)])
                            for g in range(2)])
    assert np.array_equal(splits, want_splits)
    want_total = sum(float(d["cost32"].sum()) for d in decs)
    assert abs(float(total) - want_total) <= 1e-4 * abs(want_total)
    want_b = sum(np.abs(tiles[t][:, :, :1] - tiles[(t - 1) % 2][:, :, -1:])
                 .sum() for t in range(2))
    assert int(boundary) == int(want_b)


def test_sharded_search_step_equals_jax_step():
    """The port's step and fasthevc_tpu/parallel/mesh.py's (jitted, on a
    (2, 2) mesh of conftest's virtual devices) on the same frames: the
    gathered splits and the boundary statistic exactly, the f32 cost sum
    to summation order."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 32, 128)).astype(np.int32)
    ls = np.float32(6.0)
    want = jax_mesh.sharded_search_step(jax_mesh.gop_tile_mesh(4, n_tile=2))(
        jnp.asarray(frames), jnp.float32(ls))
    got = sharded_search_step(gop_tile_mesh(4, n_tile=2, device="cpu"))(
        frames, float(ls))
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert int(got[2]) == int(want[2])
    assert abs(float(got[1]) - float(want[1])) <= 1e-4 * abs(float(want[1]))


def _intra_case():
    clip = synthesize_yuv(128, 64, 2, seed=13)
    cfg = EncoderConfig(width=128, height=64, qp=32, frames=2, tile_cols=2,
                        tile_rows=1, sao=True)
    return clip, cfg


def _p_case(n=4):
    clip = synthesize_yuv(128, 64, n, seed=21)
    cfg = EncoderConfig(width=128, height=64, qp=32, frames=n, tile_cols=2,
                        tile_rows=1, sao=False, intra_period=n,
                        gop=[GopEntry(1, 0, "P", (-1,))], search_range=8)
    return clip, cfg


def _decodes(stream, n):
    pics = SpecDecoder().decode(stream)
    return len(pics) == n and all(p.hash_ok for p in pics)


def test_sharded_all_intra_equals_device_route(device_route):
    clip, cfg = _intra_case()
    mesh = gop_tile_mesh(4, n_tile=2, device="cpu")
    stream, recons = sharded.sharded_encode_all_intra(clip, cfg, mesh)
    single, rec1 = TorchEncoder(cfg, device="cpu").encode(clip)
    assert stream == single, f"{len(stream)} B != {len(single)} B"
    assert _decodes(stream, len(clip))
    for a, b in zip(recons, rec1):
        assert np.array_equal(a.y, b.y)


@pytest.mark.parametrize("tmvp,sr", [(True, 8), (False, 8), (True, 16)])
def test_sharded_gop_idr_p_equals_device_route(device_route, tmvp, sr):
    """With TMVP on, the collocated motion is replayed as the single-device
    route replays it (which the reference's sharded driver does not:
    ROADMAP S10); above SR 8 the coarse search reads the exchanged
    decimated planes."""
    clip, cfg = _p_case()
    cfg = cfg.replace(temporal_mvp=tmvp, search_range=sr)
    mesh = gop_tile_mesh(2, n_tile=2, device="cpu")
    stream, recons = sharded.sharded_encode_gop(clip, cfg, mesh)
    single, rec1 = TorchEncoder(cfg, device="cpu").encode(clip)
    assert stream == single, f"{len(stream)} B != {len(single)} B"
    assert _decodes(stream, len(clip))
    for a, b in zip(recons, rec1):
        assert np.array_equal(a.y, b.y)


def test_decimated_halo_keeps_the_coarse_search_exact():
    """Above SR 8 the ME's coarse search runs on 4x4-decimated planes.  At
    a picture bound, the tile's decimated planes extended by their edge
    column (what the sharded P pipeline exchanges) give the whole
    picture's coarse bases; decimating the edge-extended planes, as the
    reference's pipeline does (ROADMAP S11), does not where the edge
    columns differ from their neighbours."""
    from fasthevc_tpu_torch.ops.me import downsample4, me_state

    w, h, halo, tw = 512, 64, 128, 128
    rng = np.random.default_rng(0)
    ref = rng.integers(60, 200, (h, w)).astype(np.int32)
    cur = rng.integers(60, 200, (h, w)).astype(np.int32)
    ref[:, 0] = ref[:, -1] = 0
    cur[:, :48] = cur[:, -48:] = 0
    y, r = torch.from_numpy(cur), torch.from_numpy(ref)[None]
    full = me_state(y, r, 64)
    dec = downsample4(torch.stack([y, r[0]]))

    def ext(p, x0, hl, t):
        return p[..., np.clip(np.arange(x0 - hl, x0 + t + hl), 0,
                              p.shape[-1] - 1)]

    n, g0, gt = 32, halo // 32, tw // 32
    for tile in (0, 3):
        x0 = tile * tw
        for exchanged in (True, False):
            st = me_state(ext(y, x0, halo, tw), ext(r, x0, halo, tw), 64,
                          decimated=(ext(dec, x0 // 4, halo // 4, tw // 4)
                                     if exchanged else None))
            got = st.base[n][0].reshape(h // n, -1, 2)[:, g0:g0 + gt]
            want = full.base[n][0].reshape(h // n, -1, 2)[
                :, x0 // n:x0 // n + gt]
            assert torch.equal(got, want) == exchanged, (tile, exchanged)


def test_zeroed_halos_change_the_p_stream(monkeypatch):
    """The ME windows, deblocking strips and intra references of the P
    pipeline are read from the neighbours: zeroing every halo K16 brings
    changes the stream."""
    clip, cfg = _p_case(3)
    mesh = gop_tile_mesh(2, n_tile=2, device="cpu")
    ok, _ = sharded.sharded_encode_gop(clip, cfg, mesh)
    halo = port_group.ThreadGroup.halo

    def zeroed(self, planes, wl, wr, cyclic=False):
        out = halo(self, planes, wl, wr, cyclic)
        n = len(planes)
        wls = wl if isinstance(wl, (list, tuple)) else [wl] * n
        for e, p, a in zip(out, planes, wls):
            e[..., :a] = 0
            e[..., a + p.shape[-1]:] = 0
        return out

    monkeypatch.setattr(port_group.ThreadGroup, "halo", zeroed)
    dead, _ = sharded.sharded_encode_gop(clip, cfg, mesh)
    assert dead != ok


def test_picture_edge_decides_tile0_intra_maps(monkeypatch):
    """Without mpm_edge_on on tile 0 the search reads the replicated halo
    as a left neighbour: tile 0's maps change, the others' do not."""
    clip, cfg = _intra_case()
    mesh = gop_tile_mesh(2, n_tile=2, device="cpu")
    sp = cfg.replace(tile_cols=2)
    run = sharded.build_sharded_intra_pipeline(mesh, 128, 64, sao_on=True)
    planes = sharded._padded(clip, [0], 64, 128)
    args = (lambda r: (*sharded._tiles_of(planes, mesh, r, 64),
                       sharded.lambda_sqrt(sp.qp), 32, 31, 31, 32))
    ok = _run_ranks(mesh, run, args)
    search = sharded.search_intra_maps_batch

    def no_edge(*a, **kw):
        kw["mpm_edge_on"] = False
        return search(*a, **kw)

    monkeypatch.setattr(sharded, "search_intra_maps_batch", no_edge)
    forced = _run_ranks(mesh, run, args)
    assert not torch.equal(ok[0]["packed"], forced[0]["packed"])
    assert torch.equal(ok[1]["packed"], forced[1]["packed"])


def test_dist_group_gloo_stream_equals_thread_group(tmp_path):
    """The 128x64 intra dry-run case across two spawned gloo processes
    (DistGroup) writes the ThreadGroup mesh's stream (and rank 0 finds it
    equal to the single-device route's, hash-clean)."""
    from fasthevc_tpu_torch.parallel.dryrun import dryrun_configs
    from fasthevc_tpu_torch.parallel.multiproc import _free_port

    init = f"tcp://localhost:{_free_port()}"
    out = tmp_path / "dist.bin"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # rank 0 also holds the stream against the single-device device route
    env.pop("FASTHEVC_FORCE_CLASSIC", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fasthevc_tpu_torch.parallel.dryrun",
         "--ranks", "2", "--cpu", "--dist-rank", str(r), "--init", init,
         "--out", str(out)], cwd=REPO, env=env) for r in range(2)]
    rcs = [p.wait(timeout=600) for p in procs]
    assert rcs == [0, 0]
    _, cfg, clip, driver = dryrun_configs(2, 1)[0]
    mesh = gop_tile_mesh(2, device="cpu")
    want, _ = driver(clip, cfg, mesh)
    assert out.read_bytes() == want


def test_dist_group_over_gloo_refuses_cuda_tensors():
    g = port_group.DistGroup.__new__(port_group.DistGroup)
    g.backend = "gloo"

    class FakeCuda:
        is_cuda = True

    with pytest.raises(ValueError, match="CPU tensors only"):
        g._check([FakeCuda()])


# ---------------------------------------------------------------------------
# Slow tier: against the JAX package's sharded drivers
# ---------------------------------------------------------------------------

def _jax_encode(kind, clip, cfg_kw, gop_shape):
    from fasthevc_tpu.config import EncoderConfig as JaxConfig
    from fasthevc_tpu.config import GopEntry as JaxGop

    kw = dict(cfg_kw)
    if "gop" in kw:
        kw["gop"] = [JaxGop(*g) for g in kw["gop"]]
    devs = np.array(jax.devices()[:gop_shape[0] * gop_shape[1]]).reshape(
        gop_shape)
    jm = JaxMesh(devs, axis_names=("gop", "tile"))
    fn = (jax_sharded.sharded_encode_all_intra if kind == "intra"
          else jax_sharded.sharded_encode_gop)
    return fn(clip, JaxConfig(**kw), jm)[0]


# tests/test_sharded_pipeline.py's five configurations; the inter ones
# with TMVP off: the reference's sharded_encode_gop drops a picture's
# collocated motion before reading it (sharded.py:643-646 against :695),
# so its streams carry no TMVP where the single-device route's (and the
# port's) do (ROADMAP S10)
_SLOW_CASES = {
    "intra_sao_off": ("intra", (2, 4), 512, 96, 4, 11,
                      dict(qp=32, tile_cols=4, sao=False)),
    "intra_sao": ("intra", (2, 4), 512, 96, 2, 13,
                  dict(qp=32, tile_cols=4, sao=True)),
    "p_me_halo": ("gop", (2, 4), 512, 96, 8, 21,
                  dict(qp=32, tile_cols=4, sao=False, intra_period=4,
                       gop=[(1, 0, "P", (-1,))], search_range=8,
                       temporal_mvp=False)),
    "p_me_halo_1x4": ("gop", (1, 4), 512, 96, 4, 22,
                      dict(qp=32, tile_cols=4, sao=False, intra_period=4,
                           gop=[(1, 0, "P", (-1,))], search_range=8,
                           temporal_mvp=False)),
    "b_frames": ("gop", (2, 4), 256, 64, 6, 33,
                 dict(qp=32, tile_cols=4, sao=True, intra_period=3,
                      gop=[(2, 0, "P", (-2,)), (1, 1, "B", (-1, 1))],
                      search_range=8, num_ref_per_list=1,
                      temporal_mvp=False)),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(_SLOW_CASES))
def test_sharded_streams_equal_jax_sharded(name, device_route):
    """tests/test_sharded_pipeline.py's five configurations (TMVP off):
    the port's sharded stream equals the JAX package's byte for byte."""
    kind, shape, w, h, n, seed, kw = _SLOW_CASES[name]
    clip = synthesize_yuv(w, h, n, seed=seed)
    want = _jax_encode(kind, clip, dict(kw, width=w, height=h, frames=n,
                                        tile_rows=1), shape)
    pkw = dict(kw)
    if "gop" in pkw:
        pkw["gop"] = [GopEntry(*g) for g in pkw["gop"]]
    cfg = EncoderConfig(width=w, height=h, frames=n, tile_rows=1, **pkw)
    mesh = gop_tile_mesh(shape[0] * shape[1], n_tile=shape[1], device="cpu")
    fn = (sharded.sharded_encode_all_intra if kind == "intra"
          else sharded.sharded_encode_gop)
    got, _ = fn(clip, cfg, mesh)
    assert got == want, f"{name}: {len(got)} B != JAX {len(want)} B"
    assert _decodes(got, n)


@pytest.mark.slow
def test_dryrun_equals_jax_dryrun(device_route):
    """The port's dry run (8 ranks) writes the JAX dry run's streams: 1474
    and 2187 bytes (MULTICHIP_r05)."""
    from fasthevc_tpu_torch.parallel.dryrun import (dryrun_configs,
                                                    dryrun_multichip)

    got = dryrun_multichip(8, "cpu")
    for name, cfg, clip, _ in dryrun_configs(4, 2):
        jkw = {k: getattr(cfg, k) for k in (
            "width", "height", "qp", "frames", "tile_cols", "tile_rows",
            "sao", "rdoq", "intra_period", "search_range",
            "num_ref_per_list", "temporal_mvp")}
        if cfg.gop:
            jkw["gop"] = [(g.poc_offset, g.qp_offset, g.slice_type,
                           tuple(g.ref_pocs)) for g in cfg.gop]
        kind = "intra" if name == "intra_sao" else "gop"
        assert got[name] == _jax_encode(kind, clip, jkw, (2, 4)), name
    assert (len(got["intra_sao"]), len(got["idr_p"])) == (1474, 2187)
