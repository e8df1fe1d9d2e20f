"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so ``nvcc`` builds each in seconds.  The first use compiles them into
``build/repro_torch/<hash>/`` at the root of the checkout, one shared
library per source, with one ``nvcc`` process per source, all started
together.  The directory is keyed by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is downloaded.

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
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "seg_sbc.cu", CSRC / "pack.cu")
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# source → {C entry point → argtypes} (pointers and the stream as
# c_void_p, so ctypes never truncates a 64-bit address to a 32-bit int)
_SIGNATURES = {
    "seg_sbc.cu": {
        "seg_hist2side_launch": (_P, _P, _P, _I, _I, _I, _P),
        "seg_moments_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
        "seg_binarize_apply_launch": (_P, _P, _P, _P, _I, _I, _P),
        "hist2side_launch": (_P, _I, _P, _I, _P, _I, _P, _I, _P),
        "masked_moments_launch": (_P, _I, _I, _P, _P, _P, _P, _P, _P),
        "binarize_apply_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P),
    },
    "pack.cu": {
        "seg_packbits_launch": (_P, _P, _I, _P),
        "seg_select_pack_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
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


def library_path(source: Path) -> Path:
    """Where the shared library built from ``source`` lives."""
    return BUILD_ROOT / source_hash() / f"lib{source.stem}.so"


def build() -> tuple:
    """Compile every source whose library is not built yet; return the
    libraries' paths, in the order of ``SOURCES``.

    One ``nvcc`` per source, all started at once.  Each library is written
    to a temporary name and moved into place, so concurrent builds never
    load a half-written file.  ``nvcc``'s output (with ``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``<source>.nvcc.log``
    beside the libraries.
    """
    libs = tuple(library_path(src) for src in SOURCES)
    jobs = []
    for src, lib in zip(SOURCES, libs):
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, lib, tmp, cmd, proc))
    failures = []
    for src, lib, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        log = f"$ {' '.join(cmd)}\n{out}"
        (lib.parent / f"{src.name}.nvcc.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


@functools.lru_cache(maxsize=None)
def library() -> types.SimpleNamespace:
    """Every C entry point of the kernel libraries (built on first call),
    as attributes; the loaded libraries are kept in ``_libs``."""
    entries = {}
    loaded = []
    for src, path in zip(SOURCES, build()):
        lib = ctypes.CDLL(str(path))
        loaded.append(lib)
        for name, argtypes in _SIGNATURES[src.name].items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            entries[name] = fn
    return types.SimpleNamespace(_libs=tuple(loaded), **entries)


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch(entry, name: str, operand: torch.Tensor, *args) -> None:
    """Call the C entry point ``entry`` on ``operand``'s card and its
    current stream; raise on a CUDA error.

    The libraries launch on the CUDA runtime's current device, so the call
    is made with ``operand``'s card current: a tensor on ``cuda:1``
    launches there even while ``cuda:0`` is the current device.
    """
    with torch.cuda.device(operand.device):
        err = entry(*args, torch.cuda.current_stream(operand.device).cuda_stream)
    check(err, name)
