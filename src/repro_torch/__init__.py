"""The co-serving system in PyTorch for an NVIDIA H100, beside the JAX
package ``repro``, which it is held against and never imports.

Hand-written CUDA kernels (``csrc/``, bound by ``kernels/``) carry the
attention and the KV-page moves; ``kernels/ops.py`` sends CUDA tensors to
them and CPU tensors to their plain PyTorch versions.  The Mamba-2 SSM
mixer (``models/mamba2.py``) is plain PyTorch on both devices, as the
reference's is plain jnp outside any Pallas kernel.
"""
