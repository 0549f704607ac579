"""Time the kernels of another source tree against this one's, in turns.

    python3 -m amss_tpu_torch.tools.kernel_ab --old-csrc DIR [--reps N]

Builds the ``*.cu`` files in DIR (for example an earlier commit's
``amss_tpu_torch/csrc``, unpacked under the git-ignored ``build/``) into a
library of their own, beside the current sources' library.  Both libraries'
``amss_framed_matmul`` and ``amss_decode_ola`` are held against the plain
versions, then timed at the main path's shapes in the order old, new, new,
old: each entry is the median over ``--reps`` replays of a CUDA graph of 20
calls, per call (``utils/timing.py``).
Prints the card's name and power limit, then one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from amss_tpu_torch.models.front import STFTFrontEnd
from amss_tpu_torch.ops.kernels.build import build, check_launch, load_library, open_library
from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul_ref, stft_basis
from amss_tpu_torch.ops.kernels.ola import decode_ola_ref
from amss_tpu_torch.utils.config import FrontConfig
from amss_tpu_torch.utils.timing import time_ms

HOP, LENGTH, BATCH = 64, 64000, 8


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = {"old": open_library(build(args.old_csrc)[0]), "new": load_library()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(BATCH, LENGTH, generator=gen, device=dev) * 0.3
    basis = torch.as_tensor(stft_basis(256), device=dev)
    spec = framed_matmul_ref(x, basis, HOP)
    codes = torch.cat([spec, 0.5 * spec], dim=0).contiguous()  # [16, 997, 258]
    syn = STFTFrontEnd(FrontConfig()).to(dev).synthesis_basis.contiguous()
    (b1, nf, k), b2 = spec.shape, codes.shape[0]
    y_ref = decode_ola_ref(codes, syn, HOP, LENGTH)
    out1 = torch.empty_like(spec)
    out2 = torch.empty(b2, LENGTH, device=dev)

    def call(lib, which: str):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "framed_matmul":
            err = lib.amss_framed_matmul(x.data_ptr(), basis.data_ptr(), out1.data_ptr(),
                                         b1, LENGTH, 256, HOP, k, nf, stream)
        else:
            err = lib.amss_decode_ola(codes.data_ptr(), syn.data_ptr(), out2.data_ptr(),
                                      b2, nf, k, 256, HOP, LENGTH, stream)
        check_launch(lib, which, err)

    result = {"card": card, "reps": args.reps, "old_csrc": str(args.old_csrc)}
    for which, out, want in (("framed_matmul", out1, spec), ("decode_ola", out2, y_ref)):
        row = {}
        for tag, lib in libs.items():
            out.fill_(float("nan"))
            call(lib, which)
            torch.cuda.synchronize()
            row[f"{tag}_max_abs_err"] = float((out - want).abs().max())
        order = ("old", "new", "new", "old")
        times = [time_ms(lambda lib=libs[tag]: call(lib, which), rounds=args.reps)
                 for tag in order]
        row["order"] = list(order)
        row["ms"] = times
        row["old_ms"] = (times[0] + times[3]) / 2
        row["new_ms"] = (times[1] + times[2]) / 2
        result[which] = row
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
