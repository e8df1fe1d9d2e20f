"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU (its Pallas kernels in interpret mode), the
port with ``device="cpu"`` (its kernels' plain PyTorch versions).  Tests
that need the card take the :func:`cuda` fixture, which decides inside the
test run — never at import or collection time — whether a card exists.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.hist2side import SPAN_OCTAVES

BM, LANES = 8, 128
PER_BLOCK = BM * LANES


@pytest.fixture(scope="module")
def torch_one_thread():
    """torch on one CPU thread for a module's tests, restored after them:
    the suite runs six workers on the machine's cores, and torch's own
    thread pool in each (a small op a time in the recurrences' loops, a
    sort a leaf in the codec) only contends with the others."""
    with one_thread():
        yield


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread for the block, then as it was."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The CUDA device, or skip the test when this machine has no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def load_chip_smoke():
    """``chip_smoke.py`` at the repo's root as a module (its tables and
    pure helpers; nothing runs at import)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_tables", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def t(a, device="cpu") -> torch.Tensor:
    """numpy (or jax) array → torch tensor, same dtype and values."""
    return torch.from_numpy(np.array(a)).to(device)


def n(x) -> np.ndarray:
    """torch tensor or jax array → numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def segment_layout(sizes, seed: int, zero_segments=()):
    """A block-padded flat buffer holding one heavy-tailed segment of
    each size (values of both signs; segments listed in
    ``zero_segments`` are all zero).

    Returns ``(segs, xpad (nblocks*BM, LANES) f32, seg_of_block int32)``
    with ``segs = [(offset, size, values)]``.
    """
    rng = np.random.default_rng(seed)
    segs, off = [], 0
    for i, s in enumerate(sizes):
        x = (rng.standard_normal(s) * np.exp(2.0 * rng.standard_normal(s))
             ).astype(np.float32)
        if i in zero_segments:
            x[:] = 0.0
        segs.append((off, s, x))
        off += max(1, -(-s // PER_BLOCK)) * PER_BLOCK
    xpad = np.zeros((off,), np.float32)
    seg_of_block = np.zeros((off // PER_BLOCK,), np.int32)
    for i, (o, s, x) in enumerate(segs):
        xpad[o:o + s] = x
        seg_of_block[o // PER_BLOCK:(o + max(s, 1) - 1) // PER_BLOCK + 1] = i
    return segs, xpad.reshape(-1, LANES), seg_of_block


def coarse_ranges(segs):
    """Per-segment pass-1 ranges ``[absmax·2⁻³⁰, absmax·1.0001)`` for both
    sides, computed in f32 as the pipeline does."""
    absmax = np.array([np.abs(x).max() if x.size else 0.0 for _, _, x in segs],
                      np.float32) + np.float32(1e-30)
    lo = absmax * np.float32(2.0 ** -SPAN_OCTAVES)
    hi = absmax * np.float32(1.0001)
    return np.stack([lo, lo], 1), np.stack([hi, hi], 1)


def zoomed_ranges(segs, seed):
    """Narrow per-side ranges around each side's upper quantiles, as the
    second (zoomed) pass sees them."""
    rng = np.random.default_rng(seed)
    los, his = [], []
    for _, _, x in segs:
        row_lo, row_hi = [], []
        for sel in (x > 0, x < 0):
            a = np.abs(x[sel])
            if a.size < 4:
                row_lo.append(1e-3), row_hi.append(2e-3)
                continue
            q = np.sort(a)[int(a.size * rng.uniform(0.5, 0.9))]
            row_lo.append(q), row_hi.append(q * 1.8)
        los.append(row_lo), his.append(row_hi)
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def hist_params(sob, los, his):
    return np.stack([sob.astype(np.float32), los[sob, 0], his[sob, 0],
                     los[sob, 1], his[sob, 1]], axis=1)


def near_edge_mask(x: np.ndarray, lo: float, hi: float, nbins: int,
                   side: int, tol: float = 1e-4) -> np.ndarray:
    """Which of ``x``'s entries counted on ``side`` have a bucket
    coordinate, computed in float64, within ``tol`` of an integer.

    XLA's and torch's CPU ``log2`` differ by one ulp on about a quarter
    of f32 inputs, so only these entries may land in a neighbouring
    bucket between the two packages.
    """
    sel = x > 0 if side == 0 else x < 0
    a32 = np.abs(x)
    in_range = sel & (a32 >= np.float32(lo)) & (a32 < np.float32(hi))
    lg_lo = np.log2(max(float(lo), 1e-38))
    lg_hi = np.log2(max(float(hi), 2e-38))
    f = ((np.log2(np.maximum(a32.astype(np.float64), 1e-38)) - lg_lo)
         / (lg_hi - lg_lo) * nbins)
    return in_range & (np.abs(f - np.round(f)) < tol)


def near_bucket_edge(x: np.ndarray, lo: float, hi: float, nbins: int,
                     side: int, tol: float = 1e-4) -> int:
    """The number of entries :func:`near_edge_mask` marks."""
    return int(near_edge_mask(x, lo, hi, nbins, side, tol).sum())


def assert_hist_close(got: np.ndarray, want: np.ndarray, segs, los, his,
                      nbins: int) -> None:
    """Histogram counts agree, except that an entry next to a bucket edge
    (:func:`near_bucket_edge`) may sit in the neighbouring bucket.

    ``los``/``his`` are ``(nseg, 2)`` per-side ranges.  Each such entry
    changes two bins by one, so per (segment, side) the absolute
    differences sum to at most twice the number of near-edge entries, and
    the total count is equal.
    """
    assert got.shape == want.shape
    for i, (_, _, x) in enumerate(segs):
        for side in (0, 1):
            g, w = got[i, side], want[i, side]
            assert g.sum() == w.sum(), (i, side)
            edge = near_bucket_edge(x, los[i, side], his[i, side], nbins, side)
            assert np.abs(g - w).sum() <= 2 * edge, (i, side, edge)
