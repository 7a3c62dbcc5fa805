"""PyTorch port of the kNN-routed serving system (`repro`), for NVIDIA
Hopper GPUs.

The JAX package `repro` is the reference; each module here mirrors the one
of the same path there.  The port imports `torch` and numpy only — never
`jax`, and nothing of `repro`.  Kernels (`repro_torch.kernels`) are CUDA C++
built with `nvcc` at first use on a CUDA device; on CPU tensors every kernel
wrapper runs its plain-torch version instead.
"""
