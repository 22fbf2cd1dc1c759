"""The port's partition CNN and fast-partition path against
fasthevc_tpu/models/partition_cnn.py and the JAX searches on the CPU.

The twin (the conv2d chain) must give flax's logits to LOGIT_ATOL and the
reference's depth maps exactly, on clips whose smallest top-two logit
margin is at least ten times the largest logit difference (so that the
equality is not luck); parameter files load in either package; the
packing's depth override, the intra search with the CNN and the pipelined
route's stream must equal the reference's; the trainer must build the
reference's training set, take the reference's gradients and end near the
reference's parameters.  The inputs are made from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.codec.search import _pack_maps_device, decisions_to_maps
from fasthevc_tpu.codec.search import search_intra_frame as jax_search
from fasthevc_tpu.codec.search import \
    search_intra_maps_batch as jax_maps_batch
from fasthevc_tpu.config import EncoderConfig as JaxConfig
from fasthevc_tpu.models import partition_cnn as jcnn
from fasthevc_tpu.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.codec.search import _pack_maps, search_intra_maps_batch
from fasthevc_tpu_torch.config import EncoderConfig, low_delay_p
from fasthevc_tpu_torch.config.config import GopEntry
from fasthevc_tpu_torch.models import partition_cnn as tcnn
from fasthevc_tpu_torch.ops import cnn
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

# flax and the conv2d chain sum the same f32 products in other orders: the
# logits differ by a few ulps of values of order 1 (measured: under 3e-7)
LOGIT_ATOL = 1e-5


def _jax_params(seed, lg=5):
    return jax.device_get(jcnn.init_params(jax.random.PRNGKey(seed), lg))


def _luma(w, h, seed):
    return synthesize_yuv(w, h, 1, seed=seed)[0][0].astype(np.int32)


@pytest.mark.parametrize("lg", [5, 6])
def test_logits_and_depth_maps_match_flax(lg):
    params = _jax_params(3, lg)
    model = tcnn.params_from_flax(params, "cpu")
    y = _luma(192, 128, 11 + lg)
    x = jcnn._ctu_batch(y, 1 << lg)
    qs = np.linspace(22, 37, x.shape[0]).round().astype(np.float32)
    want = np.asarray(jcnn.PartitionCNN(n_depths=lg - 2).apply(
        params, jnp.asarray(x), jnp.asarray(qs)))
    got = model(torch.from_numpy(x), torch.from_numpy(qs)).detach().numpy()
    diff = np.abs(got - want).max()
    assert diff <= LOGIT_ATOL
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 10 * diff
    for qp in (27, 37):
        ref = jcnn.predict_depth_maps(params, y, qp, lg)
        np.testing.assert_array_equal(
            tcnn.predict_depth_maps(params, y, qp, lg, device="cpu"), ref)
        dev = tcnn.predict_depth_maps_device(model, torch.from_numpy(y), qp,
                                             lg)
        assert dev.dtype == torch.int16
        np.testing.assert_array_equal(
            dev.numpy(), np.asarray(jcnn.predict_depth_maps_device(
                params, jnp.asarray(y), qp, lg)))


def test_parameter_files_load_in_either_package(tmp_path):
    params = _jax_params(4)
    jcnn.save_params(params, str(tmp_path / "jax.pkl"))
    model = tcnn.params_from_flax(tcnn.load_params(str(tmp_path / "jax.pkl")),
                                  "cpu")
    tcnn.save_params(model, str(tmp_path / "port.pkl"))
    back = jcnn.load_params(str(tmp_path / "port.pkl"))
    for name, layer in params["params"].items():
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][name][key],
                                          layer[key])
    # a network the port draws runs the same in flax
    drawn = tcnn.init_params(torch.Generator().manual_seed(5), device="cpu")
    tcnn.save_params(drawn, str(tmp_path / "drawn.pkl"))
    x = jcnn._ctu_batch(_luma(64, 64, 5), 32)
    qs = np.full(x.shape[0], 30.0, np.float32)
    want = jcnn.PartitionCNN().apply(jcnn.load_params(str(tmp_path /
                                                          "drawn.pkl")),
                                     jnp.asarray(x), jnp.asarray(qs))
    got = drawn(torch.from_numpy(x), torch.from_numpy(qs)).detach().numpy()
    assert np.abs(got - np.asarray(want)).max() <= LOGIT_ATOL


def test_a_network_of_the_wrong_depth_count_raises():
    model = tcnn.params_from_flax(_jax_params(3, 5), "cpu")
    y = torch.zeros((64, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        tcnn.predict_depth_maps_device(model, y, 32, log2_ctu=6)
    with pytest.raises(ValueError):
        cnn.cnn_depth(y[None], model.flat_params(), 32, 6)


def _decisions(rng, kind, f, pw, ph, lg):
    """Seeded per-size decisions of F frames with the intra, P (the JAX
    P search's keys) or B key set: (port dict [F, B_n], JAX dicts per
    frame)."""
    port, ref = {}, [dict() for _ in range(f)]
    for n in [1 << k for k in range(3, lg + 1)]:
        b = (ph // n) * (pw // n)
        vals = {"mode": rng.integers(0, 35, (f, b)),
                "split": rng.integers(0, 2, (f, b)).astype(bool)}
        if kind != "intra":
            vals["inter"] = rng.integers(0, 2, (f, b)).astype(bool)
            vals["mv0"] = rng.integers(-64, 65, (f, b, 2))
            vals["ref0"] = rng.integers(0, 2, (f, b))
        if kind == "B":
            vals["dir"] = rng.integers(1, 4, (f, b))
            vals["mv1"] = rng.integers(-64, 65, (f, b, 2))
            vals["ref1"] = rng.integers(0, 2, (f, b))
        for key, v in vals.items():
            port[f"{key}{n}"] = torch.from_numpy(v)
            for i in range(f):
                jkey = key if kind == "B" else {"mv0": "mv",
                                                "ref0": "ref"}.get(key, key)
                ref[i][f"{jkey}{n}"] = jnp.asarray(v[i])
        if kind == "P":
            # the port's P search emits the B search's keys
            port[f"dir{n}"] = torch.ones((f, b), dtype=torch.int32)
            port[f"mv1{n}"] = torch.zeros((f, b, 2), dtype=torch.int32)
            port[f"ref1{n}"] = torch.zeros((f, b), dtype=torch.int32)
    return port, ref


@pytest.mark.parametrize("kind", ["intra", "P", "B"])
@pytest.mark.parametrize("lg,pw,ph,cw,ch", [(5, 128, 96, 120, 88),
                                             (6, 128, 128, 120, 104)])
def test_pack_maps_override_matches_jax(kind, lg, pw, ph, cw, ch):
    rng = np.random.default_rng(lg * 7 + len(kind))
    f = 2
    port, ref = _decisions(rng, kind, f, pw, ph, lg)
    override = rng.integers(0, lg - 2, (f, ph // 8, pw // 8)).astype(
        np.int16)
    pack = jax.jit(_pack_maps_device, static_argnums=(1, 2, 3, 4, 5, 6))
    got = _pack_maps(port, f, pw, ph, cw, ch, lg, 3,
                     torch.from_numpy(override))
    for i in range(f):
        want = np.asarray(pack(ref[i], pw, ph, cw, ch, lg, 3,
                               jnp.asarray(override[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)
    # the override replaced the DP's splits
    assert not torch.equal(got[..., 0],
                           _pack_maps(port, f, pw, ph, cw, ch, lg, 3)[..., 0])


def _clip96():
    """tests/test_partition_cnn.py::test_fast_partition_encode_conformant's
    clip (96x64, 2 frames, QP32), so that the JAX programs are shared."""
    return synthesize_yuv(96, 64, 2, seed=61)


def test_intra_maps_with_the_cnn_match_jax():
    params = _jax_params(3)
    clip = _clip96()
    planes = [np.stack([f[p] for f in clip]).astype(np.uint8)
              for p in range(3)]
    ls = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    want = np.asarray(jax_maps_batch(
        jnp.asarray(planes[0]), jnp.float32(ls), 5, 3, 96, 64,
        cnn_params=params, qp=32, use_cnn=True,
        cb_u8_batch=jnp.asarray(planes[1]),
        cr_u8_batch=jnp.asarray(planes[2]), rd_cands=3))
    y, cb, cr = (torch.from_numpy(p) for p in planes)
    kw = dict(cb_batch=cb, cr_batch=cr, rd_cands=3)
    model = tcnn.params_from_flax(params, "cpu")
    got = search_intra_maps_batch(y, ls, 5, 3, 96, 64, **kw, cnn=model,
                                  qp=32)
    np.testing.assert_array_equal(got.numpy(), want)
    full = search_intra_maps_batch(y, ls, 5, 3, 96, 64, **kw)
    assert not torch.equal(got[..., 0], full[..., 0])


def test_pipelined_stream_matches_tpu_encoder():
    """Under FASTHEVC_FORCE_CLASSIC (tests/conftest.py) both encoders take
    the pipelined route; with the same CNN they write the same bytes."""
    params = _jax_params(3)
    clip = _clip96()
    kw = dict(width=96, height=64, qp=32, frames=2, fast_partition=True)
    want, _ = TpuEncoder(JaxConfig(**kw), partition_params=params).encode(
        clip)
    enc = TorchEncoder(EncoderConfig(**kw), "cpu", partition_params=params)
    got, _ = enc.encode(clip)
    assert "search_s" in enc.timing
    assert got == want
    pics = SpecDecoder().decode(got)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)


# a hierarchical-B GOP of two (POC 2 from the IDR, then POC 1 between
# them): the random-access route's B batches on 3 frames, where
# random_access_gop16 needs 17
HIER_B2 = [GopEntry(2, 1, "B", (-2, -4), 0), GopEntry(1, 2, "B", (-1, 1), 1)]


@pytest.mark.parametrize("make,frames", [
    (lambda: EncoderConfig(width=64, height=64, qp=32, frames=2), 2),
    (lambda: low_delay_p(width=64, height=64, qp=32, frames=2), 2),
    (lambda: EncoderConfig(width=64, height=64, qp=32, frames=3,
                           intra_period=32, gop=HIER_B2), 3),
], ids=["all-intra", "low-delay-P", "random-access"])
def test_device_routes_encode_with_the_cnn(monkeypatch, make, frames):
    """The port's device routes with fast_partition: a hash-clean stream
    that is not the full search's (the reference's device routes, byte for
    byte, with random_access_gop16: the slow tier)."""
    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    params = tcnn.params_to_flax(
        tcnn.init_params(torch.Generator().manual_seed(7), device="cpu"))
    clip = synthesize_yuv(64, 64, frames, seed=9)
    cfg = make()
    enc = TorchEncoder(cfg.replace(fast_partition=True), "cpu",
                       partition_params=params)
    fast, _ = enc.encode(clip)
    assert "device_s" in enc.timing
    full, _ = TorchEncoder(cfg, "cpu").encode(clip)
    assert fast != full
    pics = SpecDecoder().decode(fast)
    assert len(pics) == frames and all(p.hash_ok for p in pics)


@pytest.fixture(scope="module")
def clip128():
    """tests/test_partition_cnn.py's training clip: 128x64, 3 frames."""
    return synthesize_yuv(128, 64, 3, seed=7)


def test_training_set_matches_jax(clip128):
    """x, t and q as train_self_distilled builds them (partition_cnn.py:
    128-146), from the JAX search and from the port's."""
    x, t, q = tcnn.distillation_targets(clip128, (32,), 5, "cpu")
    lam = float(np.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    for i, (y, _, _) in enumerate(clip128):
        yp = y.astype(np.int32)
        dec = jax.device_get(jax_search(jnp.asarray(yp), jnp.float32(lam),
                                        5, 3))
        depth = decisions_to_maps(dec, 128, 64, 128, 64, 5, 3)[0]
        want_t = (depth.reshape(2, 4, 4, 4).transpose(0, 2, 1, 3)
                  .reshape(-1, 4, 4))
        np.testing.assert_array_equal(x[8 * i:8 * i + 8],
                                      jcnn._ctu_batch(yp, 32))
        np.testing.assert_array_equal(t[8 * i:8 * i + 8], want_t)
    assert t.dtype == np.int32 and q.dtype == np.float32
    assert (q == 32.0).all() and x.shape == (24, 32, 32, 1)
    assert len(np.unique(t)) > 1


def test_one_step_matches_value_and_grad(clip128):
    """Loss, accuracy and the ten gradients of one batch of 64 CTUs
    against jax.value_and_grad of the reference's loss: rtol 1e-4, with an
    absolute floor of 1e-6 of each tensor's largest gradient where sums of
    1024 products a CTU cancel to near zero."""
    x, t, q = tcnn.distillation_targets(clip128, (27, 37), 5, "cpu")
    idx = np.random.default_rng(0).integers(0, x.shape[0], 64)
    xb, tb, qb = x[idx], t[idx], q[idx]
    params = _jax_params(0)
    model = jcnn.PartitionCNN(n_depths=3)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(xb), jnp.asarray(qb))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tb)).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    acc = float((jnp.argmax(logits, -1) == jnp.asarray(tb)).mean())
    theta = tcnn.params_from_flax(params, "cpu").flat_params()
    theta.requires_grad_(True)
    tloss, tlogits = cnn.cnn_loss(theta, torch.from_numpy(xb[..., 0]),
                                  torch.from_numpy(qb), torch.from_numpy(tb))
    tgrad, = torch.autograd.grad(tloss, theta)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-4)
    assert float((torch.argmax(tlogits, -1) == torch.from_numpy(tb))
                 .float().mean()) == acc
    back = tcnn.params_to_flax(tcnn.PartitionCNN.from_flat(tgrad, 3))
    for name, layer in grads["params"].items():
        for key in ("kernel", "bias"):
            g = np.asarray(layer[key])
            np.testing.assert_allclose(back["params"][name][key], g,
                                       rtol=1e-4,
                                       atol=1e-6 * np.abs(g).max())


# Adam divides each gradient by its running RMS, so a parameter whose
# gradient differs in its last bits moves by up to lr = 3e-3 a step in the
# worst case; measured over 20 steps the two trainers end within 1.5e-6 of
# each other (the largest parameter is 0.75, the largest move 0.057) and
# the held-out logits within 4e-6.  PARAM_ATOL and LOGIT_AFTER bound these
# with room.
PARAM_ATOL = 1e-4
LOGIT_AFTER = 1e-3


def test_training_follows_jax(monkeypatch, clip128):
    """train_self_distilled(steps=20) from the same start (the port's
    init_params patched to the converted JAX init) ends at the reference's
    parameters to PARAM_ATOL; its depth map of a held-out frame equals
    the reference's wherever the top-two margin exceeds 2 LOGIT_AFTER."""
    init = _jax_params(0)
    monkeypatch.setattr(tcnn, "init_params",
                        lambda gen, lg, dev: tcnn.params_from_flax(init, dev))
    kw = dict(clips=clip128, qps=(32,), steps=20, seed=0,
              log=lambda *_: None)
    want = jax.device_get(jcnn.train_self_distilled(**kw))
    got = tcnn.train_self_distilled(**kw, device="cpu")
    moved = 0.0
    for name, layer in want["params"].items():
        for key in ("kernel", "bias"):
            np.testing.assert_allclose(got["params"][name][key], layer[key],
                                       rtol=0, atol=PARAM_ATOL)
            moved = max(moved, float(np.abs(layer[key] - init["params"][name]
                                            [key]).max()))
    assert moved > 100 * PARAM_ATOL   # the reference did move
    y = _luma(128, 64, 8)
    x = jcnn._ctu_batch(y, 32)
    qs = np.full(x.shape[0], 32.0, np.float32)
    lw = np.asarray(jcnn.PartitionCNN().apply(want, jnp.asarray(x),
                                              jnp.asarray(qs)))
    lg_ = tcnn.params_from_flax(got, "cpu")(torch.from_numpy(x),
                                     torch.from_numpy(qs)).detach().numpy()
    assert np.abs(lg_ - lw).max() <= LOGIT_AFTER
    top2 = np.sort(lw, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * LOGIT_AFTER
    assert sure.mean() > 0.9
    assert (lw.argmax(-1) == lg_.argmax(-1))[sure].all()


@pytest.mark.slow
@pytest.mark.parametrize("make,frames", [
    (lambda: dict(width=64, height=64, qp=32, frames=2), 2),
    (lambda: dict(width=64, height=64, qp=32, frames=3, gop="ldp"), 3),
    (lambda: dict(width=64, height=64, qp=32, frames=17, gop="ra"), 17),
], ids=["all-intra", "low-delay-P", "random-access"])
def test_device_routes_match_tpu_encoder(monkeypatch, make, frames):
    """The port's device routes with fast_partition against TpuEncoder's,
    byte for byte (XLA compiles each JAX device program anew for the
    static use_cnn: minutes on the CPU)."""
    from fasthevc_tpu.config import low_delay_p as jax_ldp
    from fasthevc_tpu.config import random_access_gop16 as jax_ra
    from fasthevc_tpu_torch.config import random_access_gop16

    monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC", raising=False)
    kw = make()
    gop = kw.pop("gop", None)
    port_make, jax_make = {None: (EncoderConfig, JaxConfig),
                           "ldp": (low_delay_p, jax_ldp),
                           "ra": (random_access_gop16, jax_ra)}[gop]
    params = _jax_params(3)
    clip = synthesize_yuv(64, 64, frames, seed=9)
    want, _ = TpuEncoder(jax_make(**kw, fast_partition=True),
                         partition_params=params).encode(clip)
    enc = TorchEncoder(port_make(**kw, fast_partition=True), "cpu",
                       partition_params=params)
    got, _ = enc.encode(clip)
    assert "device_s" in enc.timing
    assert got == want
    pics = SpecDecoder().decode(got)
    assert len(pics) == frames and all(p.hash_ok for p in pics)
