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

Beside the build and :func:`launch`, the machinery that the one-launch
kernels (``seg_hist2side`` and the per-leaf ``hist2side``, ``seg_moments``
and the per-leaf ``masked_moments``, ``seg_accumulate``, ``seg_select_pack``,
``f32_mean_xla``) share:
the size of a one-wave persistent grid (:func:`persistent_grid`) and the
self-cleaning scratch they count in (:class:`Workspace`).

A wrapper given tensors on the ``meta`` device (the dry run of
``repro_torch.launch.dryrun``) launches nothing: it returns its plain
version's shapes and dtypes and calls :func:`meta_launch`, which adds
one call and the bytes its bound counts (each input read once, each
output written once) to :data:`META_TALLY`.  Its ``launches`` count, the
card's, is left as it is.
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
SOURCES = (CSRC / "seg_sbc.cu", CSRC / "pack.cu", CSRC / "reduce.cu")
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
        "seg_hist2side_resident": (_I,),
        "seg_moments_resident": (),
        "seg_hist2side_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "seg_moments_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "seg_binarize_apply_launch": (_P, _P, _P, _P, _I, _I, _P),
        "seg_accumulate_resident": (),
        "seg_accumulate_launch": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P),
        "hist2side_resident": (_I,),
        "hist2side_launch": (_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P),
        "masked_moments_gpw": (_I,),
        "masked_moments_launch": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _P),
        "binarize_apply_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P),
    },
    "pack.cu": {
        "seg_packbits_launch": (_P, _P, _I, _P),
        "seg_packbits_stream_launch": (_P, _P, _I, _P),
        "seg_select_pack_resident": (_I,),
        "seg_select_pack_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "reduce.cu": {
        "f32_mean_xla_resident": (),
        "f32_mean_xla_launch": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
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


# kernel name → [calls, bytes] on meta tensors since the last reset
META_TALLY: dict = {}


def meta_launch(name: str, nbytes: int) -> None:
    """Count one call of kernel ``name`` on ``meta`` tensors, moving
    ``nbytes``."""
    got = META_TALLY.setdefault(name, [0, 0])
    got[0] += 1
    got[1] += int(nbytes)


def reset_meta() -> None:
    META_TALLY.clear()


def check_device(t: torch.Tensor) -> None:
    """``ValueError`` unless ``t`` is on the CPU, a card or ``meta``."""
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {t.device}")


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


# ------------------------------------------------- the one-launch kernels


def persistent_grid(nblocks: int, sms: int, resident: int) -> int:
    """CTAs of a one-wave persistent grid over ``nblocks`` data blocks:
    every SM holds ``resident`` at once, no CTA is without a block, and
    there is at least one (its last CTA writes the result even when there
    is no block)."""
    return max(1, min(nblocks, sms * resident))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of card ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class Workspace:
    """Zeroed int32 scratch of the one-launch kernels: one buffer per
    (device, stream), so calls on two streams never share counts.

    Every launch leaves the words it used at zero (its last CTA clears
    them), so a buffer is zeroed once, when it is allocated, and never by
    the host again.  A call that needs more words than the buffer holds
    replaces it with a zeroed one of at least twice the size; the old one
    goes back to the stream-ordered allocator.

    A call captured into a CUDA graph gets a buffer of its own, zeroed in
    the graph (a memset before the kernel on every replay), and the kept
    buffers are left alone: a graph may replay on any stream, beside eager
    calls and other graphs.
    """

    def __init__(self) -> None:
        self.buffers: dict = {}

    def get(self, device: torch.device, stream: int, words: int,
            capturing: bool = False) -> torch.Tensor:
        if capturing:
            return torch.zeros(words, dtype=torch.int32, device=device)
        key = (device.type, device.index, stream)
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < words:
            size = max(words, 0 if buf is None else 2 * buf.numel())
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            self.buffers[key] = buf
        return buf


# the wrappers keep the reference's signatures, so they own the workspace
WORKSPACE = Workspace()


def workspace(device: torch.device, words: int) -> torch.Tensor:
    """The current stream's workspace on ``device``, with ``words`` words."""
    stream = torch.cuda.current_stream(device)
    return WORKSPACE.get(device, stream.cuda_stream, words,
                         capturing=torch.cuda.is_current_stream_capturing())
