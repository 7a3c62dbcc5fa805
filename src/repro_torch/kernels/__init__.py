"""Hand-written CUDA kernels of the port, one directory each:
``kernel.cu`` (the kernel and its C entry point), ``ops.py`` (the wrapper:
checks, launch counter, output contract) and ``ref.py`` (the plain-torch
version).  A wrapper runs the plain version only for CPU tensors; for CUDA
tensors it launches its kernel or raises.  `_build` compiles the sources
with nvcc at first use."""
