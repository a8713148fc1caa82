"""Build and load the port's CUDA kernels, and the checks every kernel
wrapper makes before it launches one.

Each kernel module under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``.  The build happens at first use, into
``build/lsp_dsp_units_tpu_torch/`` beside the package, under a name keyed
on a hash of every source in ``csrc/`` and of the compiler flags, so a
fresh checkout builds everything and a changed source rebuilds.

There is no fallback: without ``nvcc`` the build raises.  A wrapper
picks its path from where its tensors lie (:func:`is_cpu`): CPU tensors
take the plain PyTorch version and never come here, CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "lsp_dsp_units_tpu_torch")

# no --use_fast_math: the knee gain needs accurate expf/logf, and the
# FFT's FP32 FMA butterflies must not flush or approximate
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or
    /usr/local/cuda.  Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of lsp_dsp_units_tpu_torch are built from source at "
        "first use and there is no fallback for CUDA tensors")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash()}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path.  The compiler's report (registers,
    shared memory, spills) is kept beside it as ``.log``."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
                               src], capture_output=True, text=True)
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, declaring each
    entry point's argument types; every entry returns a cudaError_t."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def is_cpu(*ts: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors; raises on a mix or
    any other device."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def check_cuda(dtype: torch.dtype, device: torch.device,
               **ts: torch.Tensor) -> None:
    """Contiguous tensors of ``dtype`` on ``device``."""
    for name, t in ts.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_shapes(args, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """``args`` in the order of ``shapes`` (name -> expected shape);
    raises on the first mismatch, returns the tensors by name."""
    named = dict(zip(shapes, args))
    for name, shape in shapes.items():
        if tuple(named[name].shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(named[name].shape)}")
    return named


def check_slot(w: int, p_n: int) -> None:
    """A ring slot index in [0, P)."""
    if not 0 <= w < p_n:
        raise ValueError(f"slot {w} outside the ring of {p_n}")


def check_cuda_f32(**ts: torch.Tensor) -> None:
    """For kernels that read rows as float2/float4: contiguous float32 on
    one device, 16-byte aligned."""
    check_cuda(torch.float32, next(iter(ts.values())).device, **ts)
    for name, t in ts.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (a view with "
                             f"an offset? pass a copy)")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
