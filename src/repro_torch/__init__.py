"""PyTorch/CUDA port of the HEANA reproduction (the JAX package ``repro``
is the reference).

Mirrors ``repro`` module for module.  The main path — integer-quantized
CNN inference through the photonic GEMM — runs on an NVIDIA Hopper card
through a hand-written CUDA kernel (``kernels/csrc/taom_gemm.cu``), built
with nvcc at first use.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``, where plain PyTorch versions run instead.
Importing this package compiles nothing and imports neither JAX nor the
reference package.
"""
