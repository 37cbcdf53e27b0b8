"""Process pool for the offline featurisers.

Counterpart of dostransformer_tpu/data/pool.py. Featurising is
embarrassingly parallel across crystals, so ``workers > 1`` spreads it over
a pool of the SPAWN start method: a child starts from a fresh interpreter
and imports only the featuriser's modules (numpy and ctypes; not torch,
whose import alone takes seconds), never the parent's threads or CUDA
state. Each worker's state is set by the pool's initializer, and the serial
path runs the same initializer and task function, so order, sample ids and
error counts are the same either way.

Unless ``DOSTPU_NO_NATIVE=1``, the native library is built here before the
workers start, so they load it instead of each building it.
"""

from __future__ import annotations

import contextlib
import multiprocessing

from dostransformer_tpu_torch import native


@contextlib.contextmanager
def host_pool(workers: int, initializer=None, initargs=()):
    """Yield a spawn-context Pool of ``workers`` processes."""
    if native.enabled():
        native.library()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=initializer,
                  initargs=initargs) as pool:
        yield pool
