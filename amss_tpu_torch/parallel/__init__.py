"""Several devices (``amss_tpu/parallel``): meshes, the ranks of
data-parallel training, and the time-sharded STFT."""

from amss_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    broadcast_tensors,
    init_data_parallel,
    make_mesh,
    rank_and_world,
    run_ranks,
)
