"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, for ``sm_90a``, at first use. The
library is keyed by a hash of the sources and flags and lives in
``_kernels/`` beside this file (listed in ``.gitignore``), so an edited
source rebuilds and an unchanged one loads. It is bound with ``ctypes``:
every pointer and the stream pass as ``c_void_p``, every C entry returns
``cudaGetLastError()``, and ``check`` raises on a nonzero code.

No flag relaxes IEEE arithmetic: no ``--use_fast_math``, so ``sqrtf``
and division round correctly, as the tolerances of the tests assume.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

# C entry points: name -> argument types (every entry returns int, the
# cudaError_t of its launches, but dem_sweep_tile, kernel C's tile size)
SIGNATURES = {
    # segred.cu: rec_a, ids_a, perm_a (nullable), cap_a, rec_b, ids_b,
    #   perm_b (nullable), cap_b, n_owners, out, zero_out, stream
    "dem_seg_sum_pair": [_P, _P, _P, _INT, _P, _P, _P, _INT, _INT, _P, _INT,
                         _P],
    # segred_v1.cu: rec, ids, cap, n_owners, tile, owin, out, spill,
    #   stream
    "dem_seg_sum_v1": [_P, _P, _INT, _INT, _INT, _INT, _P, _P, _P],
    # fused_force.cu: fstat, cap, wx, wy, wz, wt, krec, own_b, h,
    #   voxel_size, with_friction, rec_a, rec_b, wc_out, ext_f, ext_t,
    #   ext_cp (the three extras nullable), stream
    "dem_fused_hertz": [_P, _INT, _P, _P, _P, _P, _P, _P, _F32, _F32,
                        _INT, _P, _P, _P, _P, _P, _P, _P],
    # fused_force.cu: fstat, cap, wx, wy, wz, wt, krec, n_owners,
    #   blk_start, uidx, uniq, ub, h, voxel_size, with_friction, rec_a,
    #   rec_b, wc_out, ext_f, ext_t, ext_cp, stream
    "dem_fused_hertz_ub": [_P, _INT, _P, _P, _P, _P, _P, _INT, _P, _P, _P,
                           _INT, _F32, _F32, _INT, _P, _P, _P, _P, _P, _P,
                           _P],
    # sweep.cu: rec, sorted_bin, idx3, fam_mask, nb, spad, n_spheres,
    #   cap, buf (outA, outB, tile status, ticket, count), stream
    "dem_sweep": [_P, _P, _P, _P, _P, _INT, _INT, _INT, _P, _P],
    "dem_sweep_tile": [],
    # uniq_layout.cu: own_a, own_b, own_b_sorted, perm_b, cap, n_owners,
    #   ub, uidx, uniq, blk_start, umax, stream
    "dem_uniq_layout": [_P, _P, _P, _P, _INT, _INT, _INT, _P, _P, _P, _P,
                        _P],
}

_lock = threading.Lock()
_lib = None
_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists.
    With `verbose`, ptxas reports each kernel's registers, shared memory
    and spills (see `build_log`); the report changes no code, so it is
    not part of the key. Returns the library path."""
    global _build_log
    extra = ["-Xptxas", "-v"] if verbose else []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libdem_kernels_{_digest()}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs, procs = [], []
    for src in (f for f in _sources() if f.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = ([_nvcc()] + ARCH_FLAGS + NVCC_FLAGS + extra
               + ["-c", "-o", str(obj), str(src)])
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    link = ([_nvcc()] + ARCH_FLAGS + ["-shared", "-o", str(tmp)]
            + [str(o) for o in objs])
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    _build_log = "".join(log for _, log, _ in logs)
    for cmd, log, rc in logs:
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler's output of the last build in this process."""
    return _build_log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_of(t) -> int:
    """The current CUDA stream of `t`'s device, as a pointer-sized int
    (the raw handle: building a ``torch.cuda.Stream`` object for it costs
    several microseconds of host time on every launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(t, dtype, shape=None, name="tensor") -> None:
    """Validate a tensor before its pointer reaches a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
