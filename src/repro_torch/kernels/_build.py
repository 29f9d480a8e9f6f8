"""Build the port's CUDA kernels at first use and load them with ctypes.

Every kernel package ``kernels/<name>/`` keeps its CUDA C++ in
``csrc/*.cu`` behind a plain C interface; ``kernels/include/`` holds the
headers they share.  The first call to :func:`load` compiles all of them,
one ``nvcc`` process per kernel, all started together, into
``build/repro_torch_kernels/<hash of sources>/lib<name>.so`` at the root of
the checkout.  Nothing is built when a module is imported, so the CPU tests
import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"
BUILD_ROOT = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_sources() -> Dict[str, List[Path]]:
    """``{kernel name: its csrc/*.cu files}`` for every kernel package."""
    out: Dict[str, List[Path]] = {}
    for src in sorted(KERNELS_DIR.glob("*/csrc/*.cu")):
        out.setdefault(src.parent.parent.name, []).append(src)
    return out


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _build_dir(srcs: Dict[str, List[Path]]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [s for name in sorted(srcs) for s in srcs[name]]
    for s in files + sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(str(s.relative_to(KERNELS_DIR)).encode())
        h.update(s.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, str]:
    """Build (or find built) every kernel library and load it.  Returns
    ``{kernel name: nvcc's output}`` (the ptxas register and spill report)."""
    with _lock:
        srcs = kernel_sources()
        out_dir = _build_dir(srcs)
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, files in srcs.items():
            so = out_dir / f"lib{name}.so"
            if so.exists():
                continue
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR),
                   "-o", str(tmp), *map(str, files)]
            procs[name] = (tmp, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, so, proc) in procs.items():
            log, _ = proc.communicate()
            (out_dir / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        logs = {}
        for name in srcs:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            log = out_dir / f"{name}.log"
            logs[name] = log.read_text() if log.exists() else ""
        return logs


def library_path(name: str) -> Path:
    """Where the built library of kernel package ``name`` lies (or will)."""
    return _build_dir(kernel_sources()) / f"lib{name}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name``, built on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``fn`` of kernel library ``name``, typed with ``argtypes``
    (every pointer and the stream as ``c_void_p``) and returning the int
    CUDA error code of its launch."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(name: str, err: int) -> None:
    """Raise if an entry point of library ``name`` returned a CUDA error."""
    if err != 0:
        f = load(name).repro_cuda_error_string
        f.argtypes = [ctypes.c_int]
        f.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({f(err).decode()})")


def check_aligned(*tensors) -> None:
    """The kernels read 16-byte vectors: refuse misaligned tensors."""
    for t in tensors:
        if t.data_ptr() % 16 or (t.stride(0) * t.element_size()) % 16:
            raise ValueError("CUDA kernel inputs must be 16-byte aligned, "
                             "with a 16-byte multiple batch stride")
