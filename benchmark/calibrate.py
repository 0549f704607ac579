"""Readings for the limits of a cell's compared numbers, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--faults 31,32,33] [--seconds 3]

For each of ``--seeds``: the cell's set-up and a short window of its own
load, then the numbers compared (the program's readings, whose largest is a
limit's lower reading).  For each of ``--control-seeds``: the reference with
its products in TF32 put in the program's place (the control, whose smallest
reading is the upper one).  For each of ``--faults``: every fault that fits the
cell (``bm/faults.py``), planted in the port.  One JSON line per
reading on standard output.  Needs the card, as ``run.py`` does.
"""

import json
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def main() -> int:
    import argparse

    import torch

    from bm import core, faults

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    def cell(seed):
        return core.make_cell(args.workload, seed, args.seconds, False, dev, time.perf_counter())

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def emit(**rec):
        print(json.dumps(rec), flush=True)

    for seed in seeds(args.seeds):
        c = cell(seed)
        kind = core.kind_module(c)
        st = kind.setup(c)
        clock = core.Clock(c)
        clock.open()
        out = kind.window(c, st, clock)
        numbers = kind.judge(c, st)
        emit(seed=seed, what="program", e2e=out["e2e"], numbers=numbers, **st)
    for seed in seeds(args.control_seeds):
        c = cell(seed)
        kind = core.kind_module(c)
        st = kind.setup(c)
        numbers = kind.control(c, st)
        emit(seed=seed, what="control", numbers=numbers, **st)
    for seed in seeds(args.faults):
        c = cell(seed)
        kind = core.kind_module(c)
        table = {**faults.SERVING, **faults.TRAINING, **faults.READ_ONLY}
        for name, plant in table.items():
            c = cell(seed)
            if not faults.applies(name, c.config, c.traffic):
                continue
            with plant(c.config):
                st = kind.setup(c)
                clock = core.Clock(c)
                clock.open()
                kind.window(c, st, clock)
            numbers = kind.judge(c, st)
            emit(seed=seed, what=f"fault:{name}", numbers=numbers, **st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
