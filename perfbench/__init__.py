"""The benchmark of the PyTorch and CUDA port, ``dostransformer_tpu_torch``.

One run measures one cell of ``BENCHMARK.json`` (``python3 -m perfbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``). Everything a
cell is made of is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/``, its limits in ``limits/`` and each per-layer
metric's reader in ``metrics/``. Nothing here imports ``jax`` or the JAX
package ``dostransformer_tpu``; ``reference.py`` imports nothing of the port.
"""
