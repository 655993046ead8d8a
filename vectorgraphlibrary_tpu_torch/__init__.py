"""vectorgraphlibrary_tpu_torch — the PyTorch/CUDA port of vectorgraphlibrary_tpu.

A second package beside the JAX one, which stays the reference: the same host
import pipeline and tile layout, with every TPU kernel of a ported path
replaced by a hand-written CUDA kernel for Hopper (csrc/, built by nvcc at
first use). It imports torch and never jax.
"""
