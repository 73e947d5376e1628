"""Hand-written CUDA kernels for Hopper, one per Pallas kernel ported.

Each follows the JAX package's split: ``kernel.py`` launches the CUDA
source under ``csrc/`` (built at first use by `_build`), ``ref.py`` is the
plain PyTorch version, ``ops.py`` picks by the tensors' device.
"""
