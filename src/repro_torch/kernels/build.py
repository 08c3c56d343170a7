"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

The sources in ``csrc/`` have a plain C interface, so they compile in seconds
without PyTorch's headers: each ``.cu`` compiles to an object file (all
``nvcc`` processes run at once), the objects link into one shared library,
and ctypes loads it.  The library lands in ``build/kernels/`` at the repo
root, named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is reused.  Nothing is built when this module
is imported: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_int8.cu", "scatter_kv.cu", "importance.cu",
           "ssd_scan.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
WAVE = 132                 # SMs of an H100 SXM: one block on each is a wave
# name -> argtypes of the C entry points (all return an int status)
SIGNATURES = {
    "repro_flash_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                              _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "repro_flash_attention_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                 _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "repro_scatter_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _I, _I,
                           _I, _P],
    "repro_fork_pages": [_P, _P, _P, _P, _I, _I, _I, _LL, _P],
    "repro_quant_scatter_rows": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _P],
    "repro_importance": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    "repro_ssd_chunk": [_I, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    "repro_ssd_chunk_tc": [_P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compiles the library if it is missing; returns (path, build seconds).
    Raises with the compiler's output if any step fails."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc(), *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc(), "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)    # atomic: a concurrent build never sees half a file
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raises if a C entry point refused its arguments or its launch failed."""
    if status == -1:
        raise ValueError(f"{name}: arguments the kernel does not take")
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")


def refuse_grad(name: str, *tensors) -> None:
    """Raises if grad mode is on and an input requires grad.  The kernels
    have no backward: autograd does not see them, so their output would
    carry no ``grad_fn`` and every parameter below it would get no
    gradient, silently.  A differentiable caller takes the plain versions
    (``impl="plain"`` in ``ops``).  ``None`` entries are skipped."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the hand-written kernel has "
                           f"no backward; call the op with impl=\"plain\" to differentiate")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on the CUDA ``device`` (a tensor's), as the
    ``cudaStream_t`` the C entry points take.  Read raw, as PyTorch's own
    generated kernels read it: ``torch.cuda.current_stream`` builds a
    ``Stream`` object per call, host time every launch pays."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t`` starts on a 16-byte boundary and each of its strides but
    the last is a multiple of 16 bytes: its rows can be copied 16 bytes at
    a time (``cp.async``), as the tensor-core bodies do."""
    nbytes = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * nbytes % 16 == 0 for s in t.stride()[:-1])
