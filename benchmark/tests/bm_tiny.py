"""Tiny versions of the cells for the CPU tests: the same files, keys and
paths at test widths."""

import copy


def tiny_config(name: str) -> dict:
    """A configuration file at CPU-test widths (the same keys and paths)."""
    from bm import core

    c = copy.deepcopy(core.load_json(core.BENCH_DIR / "configs" / f"{name}.json"))
    if c["family"] == "dpcl":
        # the embeddings keep their width: k-means on a narrower sphere does not
        # settle in 10 iterations, so the clustering check would read the seed
        c["port"]["sep"].update(hidden=8)
        c.update(blstm_hidden_dim=8)
        c["init"] = [r if r[0] != "lstm\\.weight_" else [r[0], r[1], 8 ** -0.5] for r in c["init"]]
    else:
        c["port"]["front"]["n_filters"] = 16
        c["port"]["sep"].update(hidden=8, blocks=2, repeats=1)
        c.update(N=16, B=8, Sc=8, H=32, X=2, R=1)
    return c


def tiny_traffic(name: str) -> dict:
    """A traffic mix at CPU-test sizes (the same kind and keys)."""
    from bm import core

    t = copy.deepcopy(core.load_json(core.BENCH_DIR / "traffic" / f"{name}.json"))
    if t["kind"] == "train_steps":
        t.update(batch_size=2, chunk_samples=2048, corpus={"speakers": 8, "seconds": 2})
    else:
        t["lengths_s"] = [0.3, 0.55, 1.0]  # two buckets, padded a little and much
        t["bank"] = {"speakers": 4, "seconds": 2}
        t["check_sample"] = 3
        t.update(job_mixtures=6, pool_jobs=2, max_batch=4)
    return t


def tiny_cell(workload: str, seed: int = 2**31 + 7, seconds: float = 0.5, trace: bool = False):
    import time

    import torch

    from bm import core

    m = core.load_json(core.ROOT / "BENCHMARK.json")
    w = {x["name"]: x for x in m["workloads"]}[workload]
    return core.make_cell(workload, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(), m, tiny_config(w["config"]),
                          tiny_traffic(w["traffic"]))
