"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with ``ctypes``.
Libraries land in ``build/kernels/`` at the repository root, named by a hash
of their source and flags, so an edited source rebuilds and an unchanged one
is reused.  ``build()`` starts one ``nvcc`` per missing library, all at once.
Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("banded_moments", "banded_sampler", "projline_sampler")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_log(name: str) -> Path:
    """nvcc's output of the build of kernel ``name``'s library."""
    return library_path(name).with_suffix(".log")


def build(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, in parallel.

    Returns {name: library path}.  Raises with nvcc's output on failure;
    on success the output (ptxas registers, shared memory and spills of
    every kernel) goes to ``build_log(name)``.  Each library is written to
    a temporary name and renamed into place, so concurrent builds never
    load a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    try:
        for n, path in paths.items():
            if path.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exited {proc.returncode}\n"
                              f"{out.decode(errors='replace')}")
                continue
            build_log(n).write_bytes(out)
            os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing)."""
    return ctypes.CDLL(str(build((name,))[name]))
