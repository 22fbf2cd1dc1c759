"""fasthevc_tpu_torch's GOP-parallel processes (parallel/multiproc.py).

The span splitter equals the reference's, and two worker processes on the
CPU (a gloo barrier over a loopback TCP store) write parts whose
concatenation equals a one-process encode byte for byte and decodes with
matching hashes.
"""

import pytest
import torch

from fasthevc_tpu.parallel.multiproc import _gop_spans as jax_gop_spans
from fasthevc_tpu_torch.parallel.multiproc import (_gop_spans,
                                                   gop_parallel_encode_check)

# One intra-op thread: the suite runs several test workers at once.
torch.set_num_threads(1)


@pytest.mark.parametrize("n_frames,intra_period,n_procs", [
    (16, 8, 2), (4, 2, 2), (10, 4, 3), (5, 8, 2), (6, 1, 4), (9, 0, 2),
    (9, -1, 3)])
def test_gop_spans_equal_the_reference(n_frames, intra_period, n_procs):
    assert (_gop_spans(n_frames, intra_period, n_procs)
            == jax_gop_spans(n_frames, intra_period, n_procs))


def test_gop_parallel_encode_check_on_cpu(monkeypatch):
    # the workers inherit one intra-op thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = gop_parallel_encode_check(128, 64, 4, n_procs=2, intra_period=2,
                                    device="cpu", timeout=600)
    assert res["rcs"] == [0, 0, 0], res
    assert res["byte_identical"] and res["decode_verify"], res
    assert res["ok"]
