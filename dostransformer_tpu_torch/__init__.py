"""PyTorch/CUDA port of dostransformer_tpu: the eDOS serving forward.

A second package beside the JAX reference ``dostransformer_tpu``, with the
same layout (``data/``, ``ops/``, ``nn/``, ``models/``, ``serve.py``,
``cli/``). It imports torch and numpy and never jax, flax or the JAX
package. Each Pallas kernel on the serving path is a hand-written CUDA
kernel for Hopper (``csrc/``), launched for CUDA tensors; CPU tensors take
the kernel's plain PyTorch version, which sits beside it in the same module.
"""
