"""The guard against the JAX package, and a run without a card or without
the port."""

import os
import shutil
import subprocess
import sys

from bm import core, guard


def test_whole_top_level_names():
    found = guard.forbidden_loaded(["amss_tpu_torch", "amss_tpu_torch.models.dpcl", "numpy",
                                    "jaxtyping", "flaxen"])
    assert found == []
    assert guard.forbidden_loaded(["amss_tpu.models", "amss_tpu_torch"]) == ["amss_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "optax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "optax"]


def test_no_module_of_the_benchmark_or_the_port_loads_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import bm.core, bm.gen, bm.serving, bm.flops, bm.trace, bm.weights\n"
            "import bm.kinds.offline_jobs, bm.kinds.train_steps, bm.faults\n"
            "import reference.dpcl, reference.tasnet, reference.train\n"
            "import amss_tpu_torch.infer.streaming, amss_tpu_torch.train.engine\n"
            "from bm.guard import forbidden_loaded; print(forbidden_loaded())"
            % (str(core.BENCH_DIR), str(core.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "dpcl_hershey2016.offline_wsj", "--seed", "3000000000", "--seconds",
                           "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True)


def test_without_a_card_it_fails_and_prints_no_result():
    out = _run(core.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_port_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
