"""Decoder CLI (HM TAppDecoder analog, SURVEY.md D1).

Usage:
  python -m fasthevc_tpu_torch.cli.decode -b in.bin [-o out.yuv]

Decodes with the port's NumPy SpecDecoder on the host and verifies the
decoded-picture-hash SEI; exits 1 on a hash mismatch, 2 on a corrupt or
truncated stream.
"""

from __future__ import annotations

import argparse
import sys

from ..spec.decoder import SpecDecoder
from ..utils import yuv_from_planes
from .encode import write_yuv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fasthevc-decode")
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", help="write decoded YUV")
    args = ap.parse_args(argv)

    with open(args.bitstream, "rb") as f:
        stream = f.read()
    dec = SpecDecoder()
    try:
        pics = dec.decode(stream)
    except (IndexError, AssertionError, ValueError, KeyError) as e:
        # CABAC desync / truncated payload: report cleanly like HM does
        print(f"ERROR: corrupt or truncated bitstream ({type(e).__name__}: "
              f"{e}); {len(dec.pictures)} picture(s) decoded before failure")
        return 2
    sp = dec.sp
    ok = True
    frames = []
    for pic in pics:
        status = {True: "OK", False: "MISMATCH", None: "none"}[pic.hash_ok]
        print(f"POC {pic.poc:4d} hash: {status}")
        if pic.hash_ok is False:
            ok = False
        frames.append(yuv_from_planes((pic.planes.y, pic.planes.cb,
                                       pic.planes.cr), sp.width, sp.height))
    if args.output:
        write_yuv(args.output, frames)
    print(f"DECODED {len(pics)} pictures {sp.width}x{sp.height}, "
          f"hash {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
