"""Build and load the port's CUDA kernels (nvcc into a shared library, ctypes).

Each ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "qps_slab_build": (_P,) * 6 + (_I, _I, _I, _I, _I, _F, _P),
    "qps_slab_build_prev": (_P,) * 6 + (_I, _I, _I, _I, _I, _F, _P),
    "qps_pivot_sweep_v3": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_v3_prev": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_ref": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_ref_prev": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_group": (_P, _L, _L, _P, _I, _I, _I, _P),
    "qps_pivot_sweep_group_prev": (_P, _L, _L, _P, _I, _I, _I, _P),
    "qps_pivot_sweep_2d": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_2d_prev": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_v3p": (_P, _L, _L, _P, _I, _P),
    "qps_pivot_sweep_v3p_prev": (_P, _L, _L, _P, _I, _P),
    "qps_normal_inverse": (_P,) * 6 + (_I, _I, _I, _F, _P),
    "qps_normal_inverse_prev": (_P,) * 8 + (_I, _I, _I, _F, _P),
    "qps_slab_level": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    "qps_slab_level_strip": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "qps_admm_chunk": (_P,) * 19 + (_I,) * 7 + (_F, _P),
    "qps_admm_chunk_cluster": (_P,) * 19 + (_I,) * 6 + (_F, _P),
    "qps_admm_chunk_cluster_occupancy": (_I, _I, _I, _P),
    "qps_prox_chunk": (_P,) * 16 + (_I,) * 7 + (_P,),
    "qps_prox_chunk_cluster": (_P,) * 16 + (_I,) * 6 + (_P,),
    "qps_prox_chunk_cluster_occupancy": (_I, _I, _I, _P),
    "qps_admm_chunk_minv": (_P,) * 18 + (_I,) * 6 + (_F, _F, _P),
    "qps_prox_chunk_minv": (_P,) * 17 + (_I,) * 7 + (_F, _P),
    "qps_admm_chunk_minv_cluster": (_P,) * 18 + (_I,) * 5 + (_F, _F, _P),
    "qps_admm_chunk_minv_cluster_occupancy": (_I, _I, _I, _P),
    "qps_prox_chunk_minv_cluster": (_P,) * 17 + (_I,) * 6 + (_F, _P),
    "qps_prox_chunk_minv_cluster_occupancy": (_I, _I, _I, _P),
    "qps_ell_matvec": (_P,) * 4 + (_I, _I, _P),
    "qps_ell_matvec_prev": (_P,) * 4 + (_I, _I, _P),
    "qps_routed_levels": (_P,) * 5 + (_I,) * 5 + (_P,),
    "qps_routed_levels_prev": (_P,) * 4 + (_I,) * 5 + (_P,),
    "qps_row_routed": (_P,) * 4 + (_L, _I, _I, _P),
    "qps_row_routed_blocks": (_P,) * 7 + (_I, _I, _P),
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


def _compile(cu) -> tuple[Path, str]:
    """Compile every source (one nvcc process each, in parallel) and link
    them into one shared library in a fresh temporary directory under
    BUILD_DIR; returns the library's path there and nvcc's output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs = [(p, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(p), "-o",
         str(tmp / f"{p.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in cu]
    logs, failed = [], []
    for p, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"--- {p.name}\n{out}")
        if proc.returncode != 0:
            failed.append(p.name)
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / "lib.so"),
             *(str(tmp / f"{p.stem}.o") for p in cu)],
            capture_output=True, text=True)
        logs.append(f"--- link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    log = "\n".join(logs)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    return tmp / "lib.so", log


@functools.cache
def load() -> KernelLibrary:
    """Build (if the sources changed) and load the kernel library."""
    cu, _ = _sources()
    path = BUILD_DIR / f"libqps_kernels_{source_hash()}.so"
    build_seconds, log = 0.0, ""
    if not path.exists():
        t0 = time.perf_counter()
        built, log = _compile(cu)
        build_seconds = time.perf_counter() - t0
        os.replace(built, path)  # atomic: a concurrent loader sees all or nothing
        shutil.rmtree(built.parent, ignore_errors=True)
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


def launches_kernel(name: str, t) -> bool:
    """Where a wrapper's work runs: True on a CUDA tensor (it launches its
    kernel), False on a CPU tensor (it runs its plain version); any other
    device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def launches_witness(name: str, *tensors) -> bool:
    """A witness wrapper's rule (the kept previous kernels): float32 (or,
    for the plain versions on the CPU, float64) tensors on the CPU or a CUDA
    card, as :func:`launches_kernel` places them; other dtypes raise."""
    import torch

    for t in tensors:
        if t.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"{name}: takes float32 (float64 on the CPU); "
                             f"got {t.dtype}")
    return launches_kernel(name, tensors[0])


def launch(wrapper, entry: str, *args, variant: str | None = None) -> None:
    """Call the C entry point ``entry``, count one launch on ``wrapper`` (and
    on ``wrapper.variants[variant]``, when the wrapper names its variants)
    and raise if the launch reported a CUDA error."""
    code = getattr(load().lib, entry)(*args)
    wrapper.launches += 1
    if variant is not None:
        wrapper.variants[variant] += 1
    check(code, entry)


def check_chunk(name: str, operands: dict, widths: dict, outs, active, *,
                bf16=(), windows=()):
    """Check a chunk kernel's operands; returns the lane mask as int32.

    ``operands`` maps each operand's name to (tensor, expected shape),
    ``widths`` each width the kernel tiles by 128 to its value (a nonzero
    multiple of 128). The operands and ``outs`` must pass
    :func:`require_cuda_f32`, except that the operands named in ``bf16`` are
    bfloat16 and those named in ``windows`` are read as a window of their
    first columns: their last axis may be wider than the shape says, with
    rows of a multiple of 16 bytes. ``active`` must be (B,) on their device.
    """
    import torch

    for key, (t, shape) in operands.items():
        got = tuple(t.shape)
        if key in windows:
            got = got[:-1] + (min(got[-1], shape[-1]),)
        if got != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                             f"{shape}" + (" or wider" if key in windows else ""))
    bad = {k: w for k, w in widths.items() if w % 128 or w == 0}
    if bad:
        raise ValueError(f"{name}: the widths must be nonzero multiples of "
                         f"128; got {bad}")
    keys = list(operands)
    require_cuda_f32(name, *(t for t, _ in operands.values()), *outs,
                     bf16={keys.index(k) for k in bf16},
                     windows={keys.index(k) for k in windows})
    B = outs[0].shape[0]
    if tuple(active.shape) != (B,) or active.device != outs[0].device:
        raise ValueError(f"{name}: active must be ({B},) on the operands' "
                         f"device; got {tuple(active.shape)} on {active.device}")
    return active.to(torch.int32).contiguous()


def stream_ptr(t) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *operands) -> None:
    """Raise unless every (tensor, dtype) operand is a contiguous CUDA
    tensor of that dtype, all on one device (the SpMV kernels' rule: they
    read scalars, so no alignment is asked)."""
    dev = operands[0][0].device
    for i, (t, want) in enumerate(operands):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operand {i} is on {t.device}, expected "
                             f"the CUDA device {dev}")
        if t.dtype != want:
            raise ValueError(f"{name}: operand {i} is {t.dtype}, the kernel "
                             f"takes {str(want).removeprefix('torch.')}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")


def require_cuda_f32(name: str, *tensors, bf16=frozenset(),
                     windows=frozenset()) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned float32
    CUDA tensor on one device. The tensors at the indices in ``bf16`` must be
    bfloat16 instead; those at the indices in ``windows`` must also have rows
    (last axis) of a multiple of 16 bytes."""
    import torch

    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operand {i} is on {t.device}, expected "
                             f"the CUDA device {dev}")
        want = torch.bfloat16 if i in bf16 else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name}: operand {i} is {t.dtype}, the kernel "
                             f"takes {str(want).removeprefix('torch.')}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand {i} is not 16-byte aligned")
        if i in windows and (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{name}: operand {i}'s rows are not a multiple "
                             "of 16 bytes")
