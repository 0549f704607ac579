"""Device time of a call on the card, as the port's measurement scripts take it."""

from __future__ import annotations

import numpy as np
import torch


def time_ms(fn, calls: int = 20, rounds: int = 5, warmup: int = 3,
            stream: torch.cuda.Stream | None = None) -> float:
    """Device time of one call of ``fn``, in ms.

    ``calls`` calls are captured in one CUDA graph, which is replayed
    ``rounds`` times between CUDA events; the result is the median per call.
    Replaying a graph leaves the host's launch overhead out, so a kernel
    whose Python wrapper takes longer than the kernel is still timed by the
    device.  ``fn`` must launch on the current stream.  Warm-up and capture
    run on ``stream`` when one is given (a backward's ops run on the stream of
    their forward, so time a backward on the stream its forward ran on)."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: the kernels' entry points set function attributes at launch
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) / calls for s, e in events]))
