"""Build and load the port's CUDA kernels (nvcc into a shared library, ctypes).

All ``csrc/*.cu`` files are compiled by one ``nvcc`` call for ``sm_90a`` into
``_build/libqps_kernels_<hash>.so`` inside this package (git-ignored), at the
first call that needs a kernel. The hash covers every source and header, so
an edited source rebuilds. The library has a plain C interface: every pointer
and the stream are passed as ``c_void_p``, and every entry point returns the
``cudaError_t`` of its launches, which :func:`check` turns into an exception.
Nothing is built or loaded when the package is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "qps_slab_build": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "qps_pivot_sweep_v3": (_P, _L, _L, _P, _I, _P),
    "qps_slab_level": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "qps_admm_chunk": (_P,) * 17 + (_I, _I, _I, _I, _F, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    #: Seconds spent in nvcc by this process (0.0 when the library existed).
    build_seconds: float
    #: nvcc's output (register and shared-memory use per kernel).
    build_log: str


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.cache
def load() -> KernelLibrary:
    """Build (if the sources changed) and load the kernel library."""
    cu, _ = _sources()
    path = BUILD_DIR / f"libqps_kernels_{source_hash()}.so"
    build_seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", tmp,
               *(str(p) for p in cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.qps_error_string.argtypes = [ctypes.c_int]
    lib.qps_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, build_seconds, log)


def check(code: int, name: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = load().lib.qps_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned float32
    CUDA tensor on one device."""
    import torch

    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operand {i} is on {t.device}, expected "
                             f"the CUDA device {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: operand {i} is {t.dtype}, the kernel "
                             "takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand {i} is not 16-byte aligned")
