"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and ``checks`` last); the lines before it on standard error end with each
number compared and its limit.  Without a card it exits 2 and prints no
result.  See PERF.md for the cells, the metrics and how to add either.
"""

import os
import sys
import time

T_START = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# every cache at a fixed place inside the checkout: only a cell's first run builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(_ROOT, "build", "benchmark_cache", _sub)
sys.path[:0] = [_HERE, _ROOT]

if __name__ == "__main__":
    from bm.core import main

    sys.exit(main(sys.argv[1:], T_START))
