"""PyTorch + CUDA port of detzero_tpu for NVIDIA Hopper (sm_90a).

The package mirrors detzero_tpu's layout.  It imports torch and never jax,
flax or detzero_tpu.  Hand-written CUDA kernels live in csrc/ and are built
at first use by _build.py; every kernel wrapper takes its plain PyTorch
version for CPU tensors.
"""
