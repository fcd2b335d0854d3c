"""Build the CUDA sources under ``csrc/`` into one shared library.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper) with a plain C interface; the objects are
linked into ``build/libkernels-<hash>.so`` and loaded with ``ctypes``.  The
hash covers the sources and the flags, so the library is built at its first
use and rebuilt when a source changes.  ``build/`` is listed in
``.gitignore``.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        found = os.path.join(CUDA_HOME, "bin", "nvcc")
    if found is None or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc")
    return found


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of the built library, compiling it first if needed.

    Raises ``RuntimeError`` with nvcc's stderr if a compile or the link
    fails.  The compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills) is kept beside the library as ``.log``.
    """
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / f"libkernels-{_digest(sources + headers)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            jobs.append((src, obj, proc))
        logs, errors = [], []
        for src, _, proc in jobs:
            out, err = proc.communicate()
            logs.append(f"== {src.name}\n{out}{err}")
            if proc.returncode:
                errors.append(f"nvcc failed on {src.name}:\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp_lib = Path(tmp) / lib.name
        objs = [str(obj) for _, obj, _ in jobs]
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
            capture_output=True,
            text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        lib.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    return ctypes.CDLL(str(build()))


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
