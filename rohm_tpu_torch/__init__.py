"""rohm_tpu_torch: the PyTorch + CUDA port of rohm_tpu for one NVIDIA H100.

Mirrors the JAX package's layout and names, so each module's counterpart
sits at the same path. The port imports torch and never jax, flax or the
JAX package. The PoseNet encoder layers run on hand-written Hopper kernels
(`ops/csrc`), built with nvcc at first use.
"""
