"""The port's GOP journal (fasthevc_tpu_torch.codec.journal, a verbatim
copy of fasthevc_tpu/codec/journal.py) over TorchEncoder.

An encode interrupted after 4 of 6 pictures, with a garbage tail written
after its last complete picture, resumes at the last IDR and must give
the uninterrupted stream byte for byte: on the classic per-frame route
(tests/conftest.py sets FASTHEVC_FORCE_CLASSIC), where it must also equal
TpuEncoder's stream, and on the low-delay P device route.  The journal's
entries tile the stream.  The case is tests/test_aux.py's.
"""

import pytest
import torch

from fasthevc_tpu.codec.encoder import TpuEncoder
from fasthevc_tpu.config import low_delay_p as jax_low_delay_p
from fasthevc_tpu_torch.codec.encoder import TorchEncoder
from fasthevc_tpu_torch.codec.journal import GopJournal, encode_journaled
from fasthevc_tpu_torch.config import EncoderConfig, low_delay_p
from fasthevc_tpu_torch.spec.decoder import SpecDecoder
from fasthevc_tpu_torch.utils import synthesize_yuv

# One intra-op thread: the suite runs several test workers at once, and
# PyTorch's default of one OpenMP thread per core in each of them
# oversubscribes the host many times over.
torch.set_num_threads(1)

LDP = dict(width=64, height=64, qp=35, frames=6, num_intra_rd_candidates=1,
           sao=False, deblocking=False)


def _resumed(cfg, frames, tmp_path):
    """The stream of an encode interrupted after 4 pictures (a garbage
    tail after them) and resumed over all of them."""
    sp, jp = str(tmp_path / "a.bin"), str(tmp_path / "a.journal")
    encode_journaled(TorchEncoder(cfg, "cpu"), frames[:4], sp, jp)
    with open(sp, "ab") as f:
        f.write(b"\x00\x00\x01\x00garbage")
    assert GopJournal.load(jp).last_resume_point()[0] == 3
    full = encode_journaled(TorchEncoder(cfg, "cpu"), frames, sp, jp)
    with open(sp, "rb") as f:
        assert f.read() == full
    pics = SpecDecoder().decode(full)
    assert len(pics) == 6 and all(p.hash_ok for p in pics)
    return full


@pytest.mark.parametrize("route", ["classic", "device"])
def test_journal_resume_byte_identical(route, monkeypatch, tmp_path):
    frames = synthesize_yuv(64, 64, 6, seed=72)
    cfg = low_delay_p(**LDP).replace(intra_period=3)  # IDR at 0 and 3
    if route == "device":
        monkeypatch.delenv("FASTHEVC_FORCE_CLASSIC")
    enc = TorchEncoder(cfg, "cpu")
    ref, _ = enc.encode(frames)
    assert ({"device_s", "entropy_s"} <= set(enc.timing)) == (route
                                                              == "device")
    assert _resumed(cfg, frames, tmp_path) == ref
    if route == "classic":
        jcfg = jax_low_delay_p(**LDP).replace(intra_period=3)
        assert TpuEncoder(jcfg).encode(frames)[0] == ref


def test_journal_records(tmp_path):
    frames = synthesize_yuv(64, 64, 3, seed=73)
    cfg = EncoderConfig(width=64, height=64, qp=35, frames=3,
                        num_intra_rd_candidates=1, sao=False)
    sp, jp = tmp_path / "s.bin", tmp_path / "s.journal"
    stream = encode_journaled(TorchEncoder(cfg, "cpu"), frames, str(sp),
                              str(jp))
    j = GopJournal.load(str(jp))
    assert len(j.entries) == 3
    assert all(e.is_idr for e in j.entries)  # all-intra
    assert j.entries[0].offset > 0  # after parameter sets
    # offsets + sizes tile the stream exactly
    for a, b in zip(j.entries, j.entries[1:]):
        assert a.offset + a.size == b.offset
    assert j.entries[-1].offset + j.entries[-1].size == len(stream)
    with open(sp, "rb") as f:
        assert f.read() == stream
