"""PyTorch/CUDA port of dostransformer_tpu: eDOS serving and training.

A second package beside the JAX reference ``dostransformer_tpu``, with the
same layout (``data/``, ``ops/``, ``nn/``, ``models/``, ``train/``,
``serve.py``, ``cli/``). It imports torch and numpy and never jax, flax or
the JAX package. Each Pallas kernel on the serving and training paths is a
hand-written CUDA kernel for Hopper (``csrc/``), launched for CUDA tensors;
CPU tensors take the kernel's plain PyTorch version, which sits beside it in
the same module.
"""
