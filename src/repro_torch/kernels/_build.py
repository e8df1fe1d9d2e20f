"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so one ``nvcc`` call builds them in seconds.  The first use compiles them
into ``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is downloaded.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` and no ``--use_fast_math``,
so the kernels round like the plain PyTorch versions they are held
against (IEEE division, full-precision ``log2f``, denormals kept).
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
SOURCES = (CSRC / "seg_sbc.cu",)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "libseg_sbc.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point → argtypes (pointers and the stream as c_void_p, so ctypes
# never truncates a 64-bit address to a 32-bit int)
_SIGNATURES = {
    "seg_hist2side_launch": (_P, _P, _P, _I, _I, _I, _P),
    "seg_moments_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "seg_binarize_apply_launch": (_P, _P, _P, _P, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the port's CUDA kernels are built from source on first use"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the kernels unless the current sources are already built.

    The library is written to a temporary name and moved into place, so
    concurrent builds never load a half-written file.  ``nvcc``'s output
    (with ``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``nvcc.log`` beside the library.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (lib.parent / "nvcc.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
