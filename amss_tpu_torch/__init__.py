"""amss_tpu_torch: the PyTorch/CUDA port of amss_tpu.

It imports torch and numpy and nothing of JAX or of the JAX package.  The
kernels in ``csrc/`` are built with ``nvcc`` at their first launch on a CUDA
tensor; on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
