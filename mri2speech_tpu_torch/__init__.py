"""PyTorch/CUDA port of mri2speech_tpu for the NVIDIA H100.

Mirrors the module layout of the JAX package `mri2speech_tpu`, which stays the
reference; this package imports neither it nor JAX. Kernels are hand-written
CUDA C++ under `csrc/`, built with nvcc at first use (`ops/_build.py`).
"""
