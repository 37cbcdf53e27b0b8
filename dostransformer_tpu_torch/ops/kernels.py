"""Build and load the port's hand-written CUDA kernels.

The sources in ``dostransformer_tpu_torch/csrc/*.cu`` have a plain C
interface (``*.cuh`` are headers they share). At first use each is compiled
with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together),
and the objects are linked into one shared library under
``build/torch_kernels/`` of the checkout, named by a hash of the flags and of
every file under ``csrc/``, and loaded with ``ctypes``. A later process finds
the library and skips the build. Nothing here runs at import: the CPU
tests import every module on machines without ``nvcc``.

The wrappers in ``ops/fused_mp.py``, ``ops/attention.py`` (forward and
backward kernels alike), ``ops/segment.py`` and ``nn/layernorm.py`` pass
every pointer, and
PyTorch's current CUDA stream, as ``c_void_p``; each entry point returns the
CUDA error code of its launches, and :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("runtime.cu", "fused_mp.cu", "fused_mp_bwd.cu", "attention.cu",
           "attention_bwd.cu", "segment_sum.cu", "attention_ln.cu",
           "layernorm_bwd.cu")
# -split-compile 0 (nvcc >= 12.1): the kernels of one source are optimised on
# every core; the attention sources instantiate 16 widths, and the whole
# build waits for the slowest (51 s without the flag, 26 s with it, 8 cores)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile", "0", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "dostpu_error_string": ([_I], ctypes.c_char_p),
    # M H -> 1 (tensor-core form) or 0 (generic form)
    "dostpu_fused_mp_form": ([_I, _I], _I),
    "dostpu_fused_mp_bwd_form": ([_I, _I], _I),
    # B E M H form, for each of the next five; the tiles also take pointers
    # to the ints they fill (te hb; te cluster splits)
    "dostpu_fused_mp_edge_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "dostpu_fused_mp_edge_tile": ([_I] * 5 + [_IP] * 2, None),
    "dostpu_fused_mp_edge_bwd_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "dostpu_fused_mp_edge_bwd_tile": ([_I] * 5 + [_IP] * 3, None),
    "dostpu_fused_mp_edge_bwd_scratch_floats": ([_I] * 5, ctypes.c_size_t),
    # src_proj dst_proj edge_proj senders receivers edge_mask ln_scale
    # ln_bias alpha w1 b1 e_out agg e_out32|null B A E M H form bf16 stream
    "dostpu_fused_mp_edge_fwd": ([_P] * 14 + [_I] * 7 + [_P], _I),
    # src_proj dst_proj edge_proj senders receivers edge_mask ln_scale
    # ln_bias alpha w1 g_eout g_agg | g_src_proj g_dst_proj g_edge_proj
    # g_ln_scale g_ln_bias g_alpha g_w1 g_b1 scratch | B A E M H form bf16
    # stream
    "dostpu_fused_mp_edge_bwd": ([_P] * 21 + [_I] * 7 + [_P], _I),
    # D -> nc slices
    "dostpu_attention_plan": ([_I, _IP, _IP], None),
    # q k v bias out stats|null B Lq Lk D scale bf16 stream
    "dostpu_attention_fwd": ([_P] * 6 + [_I] * 4 + [ctypes.c_float, _I, _P],
                             _I),
    # B Lq Lk D
    "dostpu_attention_bwd_scratch_floats": ([_I] * 4, ctypes.c_size_t),
    # q k v bias o|null g dq dk dv stats_in|null scratch B Lq Lk D scale
    # bf16 stream
    "dostpu_attention_bwd": ([_P] * 11 + [_I] * 4 + [ctypes.c_float, _I, _P],
                             _I),
    # data ids out B E F N stream (float32; the same for bfloat16)
    "dostpu_segment_sum": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "dostpu_segment_sum_bf16": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # B E F N -> vec lanes slots segs
    "dostpu_segment_sum_plan": ([_I] * 4 + [_IP] * 4, None),
    # x xk xv ln_scale ln_bias key_mask|null out B Lq Lk D scale eps bf16
    # stream
    "dostpu_attention_ln_fwd": ([_P] * 7 + [_I] * 4 + [ctypes.c_float] * 2
                                + [_I, _P], _I),
    # rows D bf16 -> vector_form slabs cluster rows_per_rank grid
    "dostpu_layer_norm_bwd_plan": ([_I] * 3 + [_IP] * 5, None),
    # xhat|x mean|null rstd dy scale dx dscale dbias rows D bf16 stream
    "dostpu_layer_norm_bwd": ([_P] * 8 + [_I] * 3 + [_P], _I),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    """Named by a hash of the flags and of every file under ``csrc/``, the
    headers too: an edited header must not find a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libdostpu_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists (or
    ``force``). Returns (library path, seconds spent compiling, 0.0 when
    cached)."""
    so = library_path()
    if so.exists() and not force:
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}.{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    failed = []
    for cmd, proc in procs:  # wait for every compile, then report
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = so.with_name(f"{tag}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def require(kernel: str, arg: str, t, *, device, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of
    ``shape`` on ``device`` whose dtype is ``dtype`` (or one of them, for a
    set): what a kernel's C entry point assumes of every pointer it is
    given."""
    if t.device != device:
        raise ValueError(f"{kernel}: {arg} is on {t.device}, expected "
                         f"{device}")
    dtypes = dtype if isinstance(dtype, (set, frozenset, tuple)) else {dtype}
    if t.dtype not in dtypes:
        names = " or ".join(sorted(str(d) for d in dtypes))
        raise TypeError(f"{kernel}: {arg} is {t.dtype}, the kernel takes "
                        f"{names}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {arg} must be contiguous and 16-byte "
                         f"aligned")


def check(code: int, kernel: str) -> None:
    if code != 0:
        msg = library().dostpu_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
