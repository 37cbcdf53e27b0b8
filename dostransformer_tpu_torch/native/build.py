"""Build the native host-runtime library (g++ -O3 -shared).

    python -m dostransformer_tpu_torch.native.build [--force]

The library is built at first use (``native.library()``) into
``build/torch_native/`` of the source checkout, never into the package (an
installed copy of the package is not supported: it would build beside its
install prefix's ``lib/``). It is named by a hash of the source, the
compiler flags, the machine type and the compiler's version: an edited
source, or a checkout copied to a host of another architecture or compiler,
gets a library of its own, so a stale or foreign one is never loaded.
Several processes may build at once (test workers, featuriser workers):
each compiles to a name of its own and renames the result into place, so a
loader never sees half a file. Every failure raises ``native.NativeError``.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys
from pathlib import Path

from dostransformer_tpu_torch.native import NativeError

SRC = Path(__file__).resolve().parent / "src" / "dostpu_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _run_compiler(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler at all
        raise NativeError(f"building the native library failed: "
                          f"{' '.join(cmd)}: {e}; set DOSTPU_NO_NATIVE=1 to "
                          f"take the NumPy path") from e


def library_path() -> Path:
    version = _run_compiler(["g++", "-dumpfullversion"]).stdout.strip()
    h = hashlib.sha256(" ".join(
        (*CXX_FLAGS, platform.machine(), version)).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libdostpu_native_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless the one for this source exists (or
    ``force``); returns its path. A failed compile raises NativeError
    with the compiler's output."""
    so = library_path()
    if so.exists() and not force:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = _run_compiler(cmd)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeError(f"building the native library failed "
                          f"({proc.returncode}): {' '.join(cmd)}\n"
                          f"{proc.stdout}{proc.stderr}\nset "
                          f"DOSTPU_NO_NATIVE=1 to take the NumPy path")
    os.replace(tmp, so)
    return so


if __name__ == "__main__":
    print(f"built {build(force='--force' in sys.argv)}")
