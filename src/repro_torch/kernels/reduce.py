"""Row sums and means of f32 values in XLA's reduce order.

The JAX package takes ``jnp.mean`` (and ``jnp.sum``) of f32 top-k values
and puts the result on the wire: SBC's μ (``core/stages.py``
``topk_signed`` and ``binarize``, the exact engines of ``core/flat.py``
and ``kernels/ops.py``).  XLA's CPU backend lowers an f32 sum of n > 32
elements to a cascade of size-32, stride-32 reduce windows:

  * pad to ``m = ceil(n / 32)`` windows, with ``pad // 2`` zeros in front
    and the rest behind;
  * sum each window left to right from 0.0;
  * repeat until 32 or fewer partials are left, then sum those left to
    right from 0.0;
  * ``jnp.mean`` is that sum × the f32 reciprocal of n (``1.0f / n``),
    not sum / n.

:func:`f32_mean_xla` computes exactly that with elementwise f32 adds only,
so its bits equal ``jnp.mean``'s (``tests/test_torch_f32mean.py`` holds
it against ``jnp.mean`` and ``jnp.sum`` under ``jit`` and ``vmap``).
``torch.sum`` and ``.mean()`` leave their order unspecified, so neither
is used.  One difference stays: XLA's CPU backend flushes denormals to
zero and the port does not, so sums that pass through a denormal may
differ.

On a CUDA tensor the whole cascade, for every row, is one launch of the
hand-written kernel of ``csrc/reduce.cu``; on a CPU tensor it is
:func:`f32_mean_xla_plain`.  It replaces no Pallas kernel: it is the
port's kernel for an XLA lowering, and no single PyTorch call sums in this
order.

The kernel's unit of work is a level-1 window (32 level-0 windows, 1,024
padded slots, one warp).  A row whose level-1 windows fit in one CTA of
:data:`CTA_WARPS` warps takes one CTA (:func:`one_cta`); a longer row is
split over :func:`ctas_per_row` CTAs of a grid that fits in one wave: the
warps of CTA c take the level-1 windows ``c · CTA_WARPS + w``, then every
``cpr · CTA_WARPS``-th after it, and the row's last CTA finishes the
upper levels.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

WINDOW = 32  # XLA's reduce-window size and stride


def _cascade_sum(v: torch.Tensor) -> torch.Tensor:
    """f32[rows, n] → f32[rows]: the windowed cascade, in torch ops."""
    while v.shape[-1] > WINDOW:
        n = v.shape[-1]
        m = -(-n // WINDOW)
        pad = m * WINDOW - n
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2)).reshape(-1, m, WINDOW)
        acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
        for j in range(WINDOW):
            acc = acc + v[..., j]
        v = acc
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def _reciprocal(n: int, device) -> torch.Tensor:
    """``1.0f / n`` as an f32 IEEE division."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.full((), float(n), dtype=torch.float32, device=device)


def f32_mean_xla_plain(vals: torch.Tensor, *, sum_only: bool = False) -> torch.Tensor:
    """Means (or with ``sum_only`` sums) over the last axis of ``vals``
    f32[..., n], in XLA's order; the result has shape ``vals.shape[:-1]``."""
    n = vals.shape[-1]
    s = _cascade_sum(vals.reshape(-1, n)).reshape(vals.shape[:-1])
    return s if sum_only else s * _reciprocal(n, vals.device)


# ------------------------------------------------ the CUDA kernel's split

CTA_WARPS = 4  # warps of a CTA of csrc/reduce.cu (its kWarps)


def _windows(n: int) -> int:
    return -(-n // WINDOW)


def level1_windows(n: int) -> int:
    """Level-1 windows of a row of ``n`` values: ``ceil(ceil(n / 32) /
    32)``, and 1 for a row of 32 or fewer level-0 windows (the kernel sums
    those as one level-1 window; zeros of the pad change no bit)."""
    return _windows(_windows(n))


def one_cta(n: int) -> bool:
    """Whether a row of ``n`` values takes the one-CTA route: its level-0
    windows fit in one CTA (32 per warp), so nothing leaves shared memory."""
    return _windows(n) <= WINDOW * CTA_WARPS


def ctas_per_row(rows: int, n: int, budget: int) -> int:
    """CTAs that each row of a call is split over: enough that every warp
    has a level-1 window, and no more than ``budget`` CTAs (one wave) for
    all rows together, but at least one.  1 on the one-CTA route."""
    if one_cta(n):
        return 1
    return max(1, min(-(-level1_windows(n) // CTA_WARPS), budget // max(rows, 1)))


@functools.lru_cache(maxsize=None)
def _budget(device_index: int) -> int:
    """CTAs of the split route that one wave of card ``device_index`` holds."""
    with torch.cuda.device(device_index):
        resident = _build.library().f32_mean_xla_resident()
    if resident < 1:
        raise RuntimeError(f"f32_mean_xla: occupancy query failed (CUDA error {-resident})")
    return _build.sm_count(device_index) * resident


def launch_ctas(rows: int, n: int, device: torch.device) -> int:
    """CTAs of the one launch for ``rows`` rows of ``n`` values on the CUDA
    ``device``."""
    return rows * ctas_per_row(rows, n, _budget(device.index))


def f32_mean_xla(vals: torch.Tensor, *, sum_only: bool = False) -> torch.Tensor:
    """Means over the last axis of ``vals`` f32[..., n] (n ≥ 1), equal bit
    for bit to ``jnp.mean(vals, axis=-1)`` on XLA's CPU backend; with
    ``sum_only`` the sums (``jnp.sum``).  See the module docstring.

    On a CUDA tensor: one launch of ``csrc/reduce.cu`` for all rows, and
    no other device operation.
    """
    if not isinstance(vals, torch.Tensor):
        raise TypeError(f"vals must be a torch.Tensor, got {type(vals)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if vals.dim() < 1 or not 1 <= vals.shape[-1] < 2 ** 31 - WINDOW:
        raise ValueError(f"vals must have 1 to 2**31 - 33 entries on its last axis, got "
                         f"shape {tuple(vals.shape)}")
    _build.check_device(vals)
    if vals.is_meta:
        _build.meta_launch("f32_mean_xla", 4 * (vals.numel() + vals.numel() // vals.shape[-1]))
        return vals.new_empty(vals.shape[:-1])
    if not vals.is_cuda:
        return f32_mean_xla_plain(vals, sum_only=sum_only)
    n = vals.shape[-1]
    x = vals.reshape(-1, n).contiguous()
    rows = x.shape[0]
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out.reshape(vals.shape[:-1])
    cpr, scratch, tickets = 1, None, None
    if not one_cta(n):
        cpr = ctas_per_row(rows, n, _budget(x.device.index))
        m1 = level1_windows(n)
        scratch = torch.empty((rows, m1 + _windows(m1)), dtype=torch.float32,
                              device=x.device)
        tickets = _build.workspace(x.device, rows)
    _build.launch(_build.library().f32_mean_xla_launch, "f32_mean_xla", x,
                  x.data_ptr(), rows, n, 0 if sum_only else 1, cpr,
                  None if scratch is None else scratch.data_ptr(),
                  None if tickets is None else tickets.data_ptr(), out.data_ptr())
    f32_mean_xla.launches += 1
    return out.reshape(vals.shape[:-1])


f32_mean_xla.launches = 0

WRAPPERS = (f32_mean_xla,)
