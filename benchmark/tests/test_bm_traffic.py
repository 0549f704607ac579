"""The inputs: the same for a seed, different across seeds, and the same
lengths for every seed."""

import numpy as np
import torch

from bm import gen

def test_speakers_repeat_for_a_seed_and_differ_across_seeds():
    big = 2**31 + 12345
    a = gen.speakers(big, 3, 1.5, "cpu")
    b = gen.speakers(big, 3, 1.5, "cpu")
    c = gen.speakers(big + 1, 3, 1.5, "cpu")
    assert a.shape == (3, 12000) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.allclose(a.abs().amax(dim=1), torch.full((3,), 0.5))
    # speech-like: silences and bursts, not a stationary tone
    frames = a[0].reshape(-1, 400).pow(2).mean(dim=1)
    assert float(frames.max() / frames.min()) > 100.0


def test_length_grid_repeats_the_mixs_lengths():
    assert gen.length_grid([6.0], 3).tolist() == [48000] * 3
    assert gen.length_grid([0.5, 1.25], 5).tolist() == [4000, 10000, 4000, 10000, 4000]


def test_mixtures_follow_the_seed():
    bank = gen.speakers(5, 4, 2.0, "cpu").numpy()
    lengths = np.array([3000, 8000, 12000])
    m1, p1 = gen.mixtures(7, bank, lengths, (-5.0, 0.0))
    m2, p2 = gen.mixtures(7, bank, lengths, (-5.0, 0.0))
    m3, _ = gen.mixtures(8, bank, lengths, (-5.0, 0.0))
    assert [len(m) for m in m1] == lengths.tolist()
    assert all(np.array_equal(a, b) for a, b in zip(m1, m2)) and np.array_equal(p1, p2)
    assert not all(np.array_equal(a, b) for a, b in zip(m1, m3))
    assert np.all(p1[:, 0] != p1[:, 2])  # two distinct speakers


def test_offline_pool_every_job_holds_the_grid(monkeypatch):
    from bm_tiny import tiny_cell
    from bm.kinds import offline_jobs

    cell = tiny_cell("dpcl_hershey2016.offline_wsj")
    st = offline_jobs.setup(cell)
    grid = sorted(gen.length_grid(cell.traffic["lengths_s"], cell.traffic["job_mixtures"]))
    for job in st["jobs"]:
        assert sorted(len(w) for w in job) == grid
    orders = [[len(w) for w in job] for job in st["jobs"]]
    assert orders[0] != orders[1] or len(set(grid)) == 1
