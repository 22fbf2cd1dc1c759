"""The port's Python commit route: TorchEncoder without the C++ slice engine.

Patching `codec.encoder._native_engine` to None, as the JAX package's
tests patch theirs (tests/test_slice_engine.py:17-25), sends every order
to the classic route, whose pictures then take the Python commit: the
search on the device (the twins here), then spec/'s commit, CABAC and
deblocking on the host.  Each case holds that route byte for byte, stream
and recon planes, against the port's C++ route on the same frames, at the
configs of the JAX package's own native-against-Python tests (file:line
beside each), and against TpuEncoder's Python route where the JAX search
programs are the ones those tests compile (XLA's persistent cache serves
them).  Only the cases against the C++ route need g++.
"""

import subprocess

import jax
import numpy as np
import pytest
import torch

import fasthevc_tpu.codec.encoder as jax_enc
import fasthevc_tpu_torch.cabac_cpp as port_cpp
import fasthevc_tpu_torch.codec.encoder as port_enc
from fasthevc_tpu.codec.search import decisions_to_trees as jax_trees
from fasthevc_tpu.config import config as jax_config
from fasthevc_tpu.models.partition_cnn import init_params
from fasthevc_tpu_torch.codec.search import (_pack_maps, maps_to_trees,
                                             search_intra_frame,
                                             search_p_frame)
from fasthevc_tpu_torch.config import config as port_config
from fasthevc_tpu_torch.utils import synthesize_yuv
from tests.test_rqt import _sparse_motion_clip
from tests.test_transform_skip import _chroma_sharp_clip
from tests.test_weighted_pred import fade_clip

# One intra-op thread: the suite runs several test workers at once.
torch.set_num_threads(1)

needs_cpp = pytest.mark.skipif(not port_cpp.available(),
                               reason="the C++ slice engine does not build "
                                      "here (no g++)")

CLASSIC_KEYS = {"search_s", "commit_s", "wall_s"}


def _p_gop(cfgmod):
    return dict(intra_period=-1, gop=[cfgmod.GopEntry(1, 1, "P", (-1,))])


def _wp_b_gop(cfgmod):
    return dict(intra_period=4,
                gop=[cfgmod.GopEntry(4, 0, "P", (-4,)),
                     cfgmod.GopEntry(2, 1, "B", (-2, 2)),
                     cfgmod.GopEntry(1, 2, "B", (-1, 1)),
                     cfgmod.GopEntry(3, 2, "B", (-1, 1))])


def _b_gop(cfgmod):
    return dict(intra_period=-1,
                gop=[cfgmod.GopEntry(4, 1, "B", (-4,)),
                     cfgmod.GopEntry(2, 3, "B", (-2, 2)),
                     cfgmod.GopEntry(1, 4, "B", (-1, 1)),
                     cfgmod.GopEntry(3, 4, "B", (-1, 1))])


def _ai(w, h, qp, frames=2, seed=None, **kw):
    return (lambda m: m.EncoderConfig(width=w, height=h, qp=qp,
                                      frames=frames, sao=False, **kw),
            lambda: synthesize_yuv(w, h, frames, seed=qp if seed is None
                                   else seed))


# name -> (the config from a config module, clip)
CASES = {
    # tests/test_slice_engine.py:28-39
    "96x64-qp32": _ai(96, 64, 32),
    "88x72-qp27": _ai(88, 72, 27),
    "64x64-qp45": _ai(64, 64, 45),
    # :42-47
    "ctu64-128x128": _ai(128, 128, 32, 1, seed=5, log2_ctu=6),
    # :50-56
    "lossless-64x64": (lambda m: m.EncoderConfig(width=64, height=64, qp=32,
                                                 frames=1, lossless=True),
                       lambda: synthesize_yuv(64, 64, 1, seed=6)),
    # :95-104 (low-delay P, its QP cascade)
    "ldp-96x64": (lambda m: m.low_delay_p(width=96, height=64, qp=33,
                                          frames=3, sao=False),
                  lambda: synthesize_yuv(96, 64, 3, seed=79)),
    # :107-118 (B pictures, two references in list 0 and list 1)
    "b-gop-96x64": (lambda m: m.EncoderConfig(width=96, height=64, qp=35,
                                              frames=5, sao=False,
                                              **_b_gop(m)),
                    lambda: synthesize_yuv(96, 64, 5, seed=80)),
    # tests/test_rqt.py:53-70
    "rqt-inter": (lambda m: m.EncoderConfig(width=96, height=64, qp=35,
                                            frames=3, sao=False,
                                            rqt_inter=True, **_p_gop(m)),
                  lambda: _sparse_motion_clip(96, 64)),
    # tests/test_transform_skip.py:105-125
    "transform-skip": (lambda m: m.EncoderConfig(width=64, height=64, qp=35,
                                                 frames=1, sao=False,
                                                 transform_skip=True),
                       lambda: _chroma_sharp_clip(64, 64, 1)),
    # tests/test_weighted_pred.py:145-166
    "wp-p-fade": (lambda m: m.EncoderConfig(width=64, height=64, qp=30,
                                            frames=3, sao=False,
                                            weighted_pred=True,
                                            num_ref_per_list=1, **_p_gop(m)),
                  lambda: fade_clip(3)),
    # :169-200
    "wp-b-fade": (lambda m: m.EncoderConfig(width=64, height=64, qp=30,
                                            frames=5, sao=False,
                                            weighted_pred=True,
                                            num_ref_per_list=1,
                                            **_wp_b_gop(m)),
                  lambda: fade_clip(5)),
    # the two-pass recon-reference search (quality()) on both commits
    "two-pass-64x64": _ai(64, 64, 32, 1, seed=4, search_recon_refs=True,
                          num_intra_rd_candidates=5),
}

_RESULTS: dict = {}


def _port_cfg(name, **extra):
    return CASES[name][0](port_config).replace(**extra)


def _port(name, engine=True, bins=True, params=None, rd_cands=3):
    """(stream, recons, timing) of the case's clip through TorchEncoder on
    the CPU twins: with the C++ slice engine, or without it (engine=False;
    bins=False also takes away the C++ bin coder), computed once."""
    key = (name, engine, bins, params is not None, rd_cands)
    if key not in _RESULTS:
        extra = {} if params is None else {"fast_partition": True}
        if rd_cands != 3:
            extra["num_intra_rd_candidates"] = rd_cands
        with pytest.MonkeyPatch.context() as m:
            if not engine:
                m.setattr(port_enc, "_native_engine", lambda: None)
            if not bins:
                m.setattr(port_cpp, "available", lambda: False)
            enc = port_enc.TorchEncoder(_port_cfg(name, **extra), "cpu",
                                        partition_params=params)
            stream, recons = enc.encode(CASES[name][1]())
        _RESULTS[key] = (stream, recons, enc.timing)
    return _RESULTS[key]


def _same(got, want) -> None:
    assert got[0] == want[0], "streams differ"
    for a, b in zip(got[1], want[1], strict=True):
        for p in ("y", "cb", "cr"):
            np.testing.assert_array_equal(np.asarray(getattr(a, p)),
                                          np.asarray(getattr(b, p)))


def _tpu_python(name, params=None, rd_cands=3):
    """TpuEncoder's Python route (its _native_engine patched to None) on
    the case's clip: (stream, recons)."""
    cfg_of, clip = CASES[name]
    cfg = cfg_of(jax_config)
    if params is not None:
        cfg = cfg.replace(fast_partition=True)
    if rd_cands != 3:
        cfg = cfg.replace(num_intra_rd_candidates=rd_cands)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_enc, "_native_engine", lambda: None)
        return jax_enc.TpuEncoder(cfg, partition_params=params).encode(clip())


@needs_cpp
@pytest.mark.parametrize("name", list(CASES))
def test_python_route_equals_cpp_route(name):
    """(a) Stream and recon of the Python commit route equal the C++
    engine's on the same decisions."""
    py = _port(name, engine=False)
    _same(py, _port(name))
    assert set(py[2]) == CLASSIC_KEYS
    if name.startswith("lossless"):
        src = CASES[name][1]()[0]
        np.testing.assert_array_equal(py[1][0].y, src[0].astype(np.int32))


def _jax_params():
    return jax.device_get(init_params(jax.random.PRNGKey(3), 5))


@pytest.mark.parametrize("name,fast,rd_cands", [("96x64-qp32", False, 3),
                                                ("ldp-96x64", False, 3),
                                                ("96x64-qp32", True, 3),
                                                ("ldp-96x64", True, 3),
                                                ("ldp-96x64", False, 5)])
def test_python_route_equals_tpu_encoder(name, fast, rd_cands):
    """(b) The port's Python route equals TpuEncoder's: all-intra and
    low-delay P at 96x64 (the JAX searches of test_slice_engine.py's
    Python routes), fast partition on both (the same CNN parameters in
    both packages), and the quality preset's intra shortlist of 5.  On
    this route both ask the CNN at cfg.qp, also for the P pictures that
    the QP cascade codes at other QPs, and search P pictures at the
    shortlist of 3, where the C++ route asks the CNN at the picture's QP
    and searches at num_intra_rd_candidates: the last two cases' streams
    differ from the C++ route's."""
    params = _jax_params() if fast else None
    _same(_port(name, engine=False, params=params, rd_cands=rd_cands),
          _tpu_python(name, params, rd_cands))


@pytest.mark.parametrize("name", ["96x64-qp32", "rqt-inter"])
def test_python_bin_coder_changes_nothing(name):
    """(c) Without the C++ bin coder as well (spec.cabac's), the stream is
    the same."""
    _same(_port(name, engine=False, bins=False), _port(name, engine=False))


def test_no_engine_turns_sao_off(monkeypatch):
    """(d) Without the engine SAO is off, as in TpuEncoder (:89-92)."""
    cfg = _port_cfg("96x64-qp32").replace(sao=True)
    monkeypatch.setattr(port_enc, "_native_engine", lambda: port_cpp)
    assert port_enc.TorchEncoder(cfg, "cpu").sp.sao_enabled
    monkeypatch.setattr(port_enc, "_native_engine", lambda: None)
    assert not port_enc.TorchEncoder(cfg, "cpu").sp.sao_enabled


def test_no_engine_refuses_tiles(monkeypatch):
    """(d) Without the engine tiles raise, as in TpuEncoder (:104-108)."""
    cfg = port_config.EncoderConfig(width=128, height=96, qp=33, frames=1,
                                    tile_cols=2, tile_rows=2)
    monkeypatch.setattr(port_enc, "_native_engine", lambda: port_cpp)
    port_enc.TorchEncoder(cfg, "cpu")
    monkeypatch.setattr(port_enc, "_native_engine", lambda: None)
    with pytest.raises(NotImplementedError, match="tiles"):
        port_enc.TorchEncoder(cfg, "cpu")


def test_no_engine_takes_the_classic_route(monkeypatch):
    """(d) Without the engine an all-intra order that the device route
    would take (FASTHEVC_FORCE_CLASSIC unset) takes the classic route
    (timing keys search_s, commit_s, wall_s), with the same stream."""
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    monkeypatch.setattr(port_enc, "_native_engine", lambda: None)
    enc = port_enc.TorchEncoder(_port_cfg("96x64-qp32"), "cpu")
    stream, _ = enc.encode(CASES["96x64-qp32"][1]())
    assert set(enc.timing) == CLASSIC_KEYS
    assert stream == _port("96x64-qp32", engine=False)[0]


def test_encode_frame_equals_tpu_encoder(monkeypatch):
    """(e) One IDR picture through the public encode_frame of both
    packages, both without the engine: the same NAL units and planes."""
    cfg_of, clip = CASES["96x64-qp32"]
    frame = clip()[0]
    monkeypatch.setattr(port_enc, "_native_engine", lambda: None)
    monkeypatch.setattr(jax_enc, "_native_engine", lambda: None)
    nal, planes = port_enc.TorchEncoder(cfg_of(port_config),
                                        "cpu").encode_frame(frame)
    want_nal, want = jax_enc.TpuEncoder(cfg_of(jax_config)).encode_frame(
        frame)
    assert nal == want_nal
    for p in ("y", "cb", "cr"):
        np.testing.assert_array_equal(getattr(planes, p), getattr(want, p))


def test_no_compiler_takes_the_python_route(monkeypatch):
    """On a host without g++ the route is chosen without patching
    _native_engine: it returns None and the encoder turns SAO off."""
    monkeypatch.setattr(port_enc.shutil, "which", lambda name: None)
    assert port_enc._native_engine() is None
    cfg = _port_cfg("96x64-qp32").replace(sao=True)
    assert not port_enc.TorchEncoder(cfg, "cpu").sp.sao_enabled


def test_failed_engine_build_raises(monkeypatch, tmp_path):
    """With g++ on the host, a C++ slice engine that fails to compile
    raises at construction: it never sends the pictures to the Python
    commit."""
    def fail(out, cmd_tail):
        raise subprocess.CalledProcessError(1, ["g++", *cmd_tail])

    monkeypatch.setattr(port_enc.shutil, "which", lambda name: name)
    monkeypatch.setattr(port_cpp, "_lib", None)
    monkeypatch.setattr(port_cpp, "_SO", str(tmp_path / "engine.so"))
    monkeypatch.setattr(port_cpp, "_compile", fail)
    with pytest.raises(subprocess.CalledProcessError):
        port_enc.TorchEncoder(_port_cfg("96x64-qp32"), "cpu")


def test_maps_to_trees_equals_reference():
    """The port's maps_to_trees, on the packed maps of the port's intra
    and P decisions, equals the reference's decisions_to_trees on the
    decisions themselves, for a picture off the CTU grid (88x72 coded in
    96x96: the forced splits and absent children)."""
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.integers(0, 256, (96, 96)).astype(np.int32))
    ref = torch.roll(y, (1, 2), (0, 1))
    ls = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    for dec in (search_intra_frame(y, ls),
                search_p_frame(y, ref[None], ls, search_range=8)):
        packed = _pack_maps({k: v[None] for k, v in dec.items()}, 1, 96, 96,
                            88, 72, 5, 3)[0]
        got = maps_to_trees(packed.numpy(), 88, 72, 5, 3)
        want = jax_trees({k: v.numpy() for k, v in dec.items()}, 96, 96, 88,
                         72, 5, 3)
        assert got == want
        assert any(t[2][0] == "split" for t in got)
