"""Offline separation jobs, closed loop, one client: each job is one
``StreamingSeparator.separate_all(waves, max_batch)`` over a corpus of
mixtures, the next sent when the last returns.  Reports ``audio_s_per_s``,
the mixture seconds of all jobs completed in the window over the window's
seconds.

Every job holds the same lengths (the mix's list, repeated to
``job_mixtures``), in the seed's order, so
every job and every seed runs the same shapes; set-up runs two jobs, which
warms every (bucket, batch) shape the window uses.  The pool of jobs is made
in set-up and cycled through in the window.
"""

from __future__ import annotations

import statistics
import time
import traceback

from bm import gen, serving
from bm.core import Cell, note, span


def setup(cell: Cell) -> dict:
    tr = cell.traffic
    state = serving.setup(cell)
    grid = gen.length_grid(tr["lengths_s"], tr["job_mixtures"])
    rng = gen.rng_for(cell.seed, 4)
    jobs = []
    for j in range(tr["pool_jobs"]):
        lengths = grid[rng.permutation(len(grid))]
        mixes, _ = gen.mixtures(cell.seed, state["bank"], lengths, tuple(tr["gain_db"]),
                                stream=100 + j)
        jobs.append(mixes)
    note(cell, "pool of jobs")
    for j in range(min(2, len(jobs))):
        with span("warmup"):
            state["sep"].separate_all(jobs[j], max_batch=tr["max_batch"])
        note(cell, f"warm-up job {j}")
    state["jobs"] = jobs
    return state


def window(cell: Cell, state: dict, clock) -> dict:
    sep, counted, jobs = state["sep"], state["counted"], state["jobs"]
    sr = cell.config["sample_rate"]
    max_batch = cell.traffic["max_batch"]
    traced = {"calls": [], "audio_samples": 0, "audio_lengths": []}
    audio = 0.0
    sent = failed = done = 0
    job_s = []
    while True:
        j = done % len(jobs)
        job = jobs[j]
        sent += len(job)
        first_call = len(counted.calls)
        ts = time.perf_counter()
        try:
            with span("job"):
                outs = sep.separate_all(job, max_batch=max_batch)
            job_s.append(time.perf_counter() - ts)
            state["outs"][j] = outs
            audio += sum(len(w) for w in job) / sr
            if clock.tracing:
                traced["calls"] += counted.calls[first_call:]
                traced["audio_lengths"] += [len(w) for w in job]
                traced["audio_samples"] += sum(len(w) for w in job)
        except Exception:  # noqa: BLE001 - a failed job is counted and reported
            failed += len(job)
            traceback.print_exc()
        done += 1
        if clock.done():
            break
    elapsed = time.perf_counter() - clock.t0
    if job_s:  # whether a slow run is slow in every job or in a few
        q = statistics.quantiles(job_s, n=10, method="inclusive") if len(job_s) > 1 else job_s * 9
        note(cell, f"{len(job_s)} jobs: seconds each min {min(job_s):.4f}, p10 {q[0]:.4f}, "
                   f"median {statistics.median(job_s):.4f}, p90 {q[8]:.4f}, max {max(job_s):.4f}")
    return {"e2e": {"audio_s_per_s": audio / elapsed}, "attempted": sent, "failed": failed,
            "counters": traced}


def judge(cell: Cell, state: dict) -> dict:
    """The numbers compared, over a sample of the answers the window
    finished."""
    answers = [(mix, out) for j, outs in sorted(state["outs"].items())
               for mix, out in zip(state["jobs"][j], outs)]
    return serving.judge(cell, state, answers)


def control(cell: Cell, state: dict) -> dict:
    """The control in the program's place, on the first job's mixtures."""
    return serving.control(cell, state, list(state["jobs"][0]))
