"""Build the hand-written CUDA kernels under ``relora_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/relora_tpu_torch/<hash>/lib<name>.so <name>.cu

The output directory is keyed by a hash of every source and the flags, so an
edited source never loads a stale library.  All sources are compiled in
parallel (one nvcc each, started together) and loaded with ``ctypes``.  A
missing nvcc or a failed compile raises: there is no fallback.

Every C entry point takes pointers and the CUDA stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launch; the Python wrapper raises
when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "relora_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
            "relora_tpu_torch are built from source at first use"
        )
    return nvcc


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet, all nvcc processes
    started together; returns ``{name: library path}``.  Raises on the first
    failed compile, with nvcc's output."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
    todo = [src for src in sources() if not libs[src.stem].exists()]
    if todo:
        nvcc = find_nvcc()
        procs = []
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, libs[src.stem])
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def stream_arg(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a kernel argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr_arg(t) -> ctypes.c_void_p:
    """``t``'s data pointer, as a kernel argument."""
    return ctypes.c_void_p(t.data_ptr())


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        path = build_all()[name]
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
