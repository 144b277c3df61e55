"""Butterfly on PyTorch/CUDA: the port of butterfly_tpu/ for NVIDIA Hopper.

Same layout and names as the JAX package (cache/paged.py is the
counterpart of butterfly_tpu/cache/paged.py, and so on). It imports
torch, numpy and the standard library, never jax or butterfly_tpu.
Entry point: python -m butterfly_tpu_torch.serve.cli serve.
"""
