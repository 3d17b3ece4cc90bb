"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

The sources in ``repro_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together, then one link)
into a shared library with a plain C interface the first time a kernel
runs, and loaded with ``ctypes``. The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. A failed build raises; nothing falls back to the plain versions.

A C interface keeps PyTorch's headers out of the build, which then takes
seconds rather than the minutes ``torch.utils.cpp_extension.load`` needs
(and that route also needs ``ninja``).
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

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "iter_fisher.cu", _PKG / "csrc" / "ssd_scan.cu")
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "ferret_compensate_packed": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "ferret_stats_packed": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _P], _I),
    "ferret_stats_scratch_len": ([_I], _I),
    "ferret_error_string": ([_I], ctypes.c_char_p),
    "ferret_ssd_workspace_len": ([_I] * 7, _L),
    # bf16 flag; x dt A B C s0 y final sb work; b l h p n Q; stream
    "ferret_ssd_fwd": ([_I] + [_P] * 10 + [_I] * 6 + [_P], _I),
    # bf16 flag; x dt A B C sb dy dfinal dx ddt dA dB dC ds0 work; b l h p n Q; stream
    "ferret_ssd_bwd": ([_I] + [_P] * 15 + [_I] * 6 + [_P], _I),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source on first use"
    )


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libferret_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the .so."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{src.stem}.o") for src in SOURCES]
        # one compile per source, all running at once, then one link
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(SOURCES, objs))
        ]
        failed = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        # rename into place, so a concurrent or interrupted build never
        # leaves a half-written library under its name
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call in a process)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().ferret_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
