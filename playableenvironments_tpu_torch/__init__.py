"""PyTorch/CUDA port of playableenvironments_tpu.

Same subpackages and module names as the JAX package, which stays the
reference. Entry points take an explicit `device` (default "cuda"); the CPU
runs the plain PyTorch versions of the kernels and is what the parity tests
use. Importing the package imports no JAX and builds no kernel.
"""
