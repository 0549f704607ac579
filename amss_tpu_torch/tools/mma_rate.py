"""The card's rate for ``mma.sync`` m16n8k8 on TF32, and what it means for the
kernels.

    python3 -m amss_tpu_torch.tools.mma_rate

Both kernels issue this instruction three times per FP32 product (3xTF32).
This tool builds ``tools/mma_rate/mma_rate.cu`` and runs it on every SM with
4, 8 and 16 warps each (32 would not fit: 16 accumulator tiles a warp take 64
registers a thread).  It prints the card's name and power limit, then one
JSON line: the best rate in TFLOP/s of TF32 (2 * 16 * 8 * 8 per
instruction), its share of the 495 TFLOP/s data-sheet peak, and the least
time the kernels' main-path products could take at that rate (3 x 1.054
GFLOP for B1, 3 x 2.108 GFLOP for B2).  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
from pathlib import Path

import torch

from amss_tpu_torch.ops.kernels.build import build
from amss_tpu_torch.utils.timing import time_ms

SRC = Path(__file__).resolve().parent / "mma_rate"
FLOP_PER_MMA = 2 * 16 * 8 * 8
ACC, ITERS = 16, 4096
PEAK_TF32 = 495e12
MAIN_PATH_GFLOP = {"framed_matmul": 1.054, "decode_ola": 2.108}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    lib = ctypes.CDLL(str(build(SRC)[0]))
    lib.amss_mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, device="cuda")

    def launch(warps: int) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        if lib.amss_mma_rate(out.data_ptr(), sms, 32 * warps, ITERS, stream) != 0:
            raise RuntimeError(f"mma_rate launch with {warps} warps per SM failed")

    rates = {}
    for warps in (4, 8, 16):
        seconds = time_ms(functools.partial(launch, warps), calls=1, rounds=3, warmup=1) * 1e-3
        rates[warps] = sms * warps * ITERS * ACC * FLOP_PER_MMA / seconds
    best = max(rates.values())
    print(json.dumps({
        "card": card,
        "tflops_by_warps_per_sm": {w: r / 1e12 for w, r in rates.items()},
        "best_tflops": best / 1e12,
        "share_of_peak": best / PEAK_TF32,
        "tf32x3_floor_us": {k: 3 * g * 1e9 / best * 1e6 for k, g in MAIN_PATH_GFLOP.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
