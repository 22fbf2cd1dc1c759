"""K5's schedule on the CPU: the ticket order of its one launch
(fasthevc_tpu_torch/ops/commit.py `ticket_order`) and the neighbours each
CTU waits for (`_waits`, as csrc/commit.cu's commit_kernel waits).

A CTU's intra CUs read recon only from the CTU itself and from the CTUs
it waits for, and those took earlier tickets, so a CTA never waits on a
ticket that no running CTA holds.
"""

import numpy as np
import pytest
import torch

from fasthevc_tpu_torch.ops import commit

torch.set_num_threads(1)


def _tickets(nctux, nctuy, frames):
    """(frame, cx, cy) -> ticket of a call of `frames` frames."""
    order = commit.ticket_order(nctux, nctuy)
    assert sorted(order.tolist()) == list(range(nctux * nctuy))
    return {(k % frames, int(order[k // frames]) % nctux,
             int(order[k // frames]) // nctux): k
            for k in range(len(order) * frames)}


def _waits(cx, cy, nctux):
    """The CTUs whose flags K5 waits for before it commits the intra CUs
    of CTU (cx, cy): its left, top-left, top and top-right neighbours
    inside the picture.  A CTU without intra CUs never waits, so the
    top-right neighbour's flag does not imply its left's: each neighbour
    is waited for itself."""
    out = [(cx - 1, cy)] if cx > 0 else []
    if cy > 0:
        out += [(x, cy - 1) for x in (cx - 1, cx, cx + 1) if 0 <= x < nctux]
    return out


def _ref_ctus(cx, cy, kind, lx, ly, n, coded_w, coded_h, nctux, tbx, tby):
    """The CTUs (cx, cy) of the available references of one block of each
    CTU [A]: a list of sets."""
    sub = 0 if kind == "l" else 1
    x0, y0 = cx * commit.CTU, cy * commit.CTU
    av = commit._np_avail(x0, y0, lx, ly, n, sub, coded_w, coded_h, nctux,
                          tbx, tby)
    ox = np.array([lx - 1] * (2 * n + 1) + [lx + j for j in range(2 * n)])
    oy = np.array([ly + j for j in range(2 * n - 1, -1, -1)] + [ly - 1]
                  + [ly - 1] * (2 * n))
    px = x0[:, None] + (ox[None] << sub)
    py = y0[:, None] + (oy[None] << sub)
    return [set(zip((px[a][av[a]] // commit.CTU).tolist(),
                    (py[a][av[a]] // commit.CTU).tolist()))
            for a in range(len(cx))]


@pytest.mark.parametrize("nctux,nctuy", [(1, 1), (4, 1), (1, 3), (5, 4),
                                         (60, 34)])
@pytest.mark.parametrize("tiles", [((), ()), ((64,), ()),
                                   ((32, 96), (32,))])
@pytest.mark.parametrize("frames", [1, 3])
def test_neighbours_read_take_earlier_tickets(nctux, nctuy, tiles, frames):
    tickets = _tickets(nctux, nctuy, frames)
    # a coded size off the CTU grid
    coded_w, coded_h = nctux * 32 - 8, nctuy * 32 - 16
    cy, cx = (a.ravel() for a in np.mgrid[0:nctuy, 0:nctux])
    reads = [set() for _ in cx]
    for kind, lx, ly, n, _ in commit._GROUPS:
        for a, ctus in enumerate(_ref_ctus(cx, cy, kind, lx, ly, n, coded_w,
                                           coded_h, nctux, *tiles)):
            reads[a] |= ctus
    for a, (x, y) in enumerate(zip(cx.tolist(), cy.tolist())):
        waits = _waits(x, y, nctux)
        assert reads[a] <= set(waits) | {(x, y)}
        for f in range(frames):
            for w in waits:
                assert tickets[(f, *w)] < tickets[(f, x, y)]
