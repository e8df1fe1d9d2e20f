"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside the wrapper (:mod:`repro_torch.kernels.flat`,
:mod:`repro_torch.kernels.pack`, and the per-leaf
:mod:`~repro_torch.kernels.hist2side`, :mod:`~repro_torch.kernels.moments`
and :mod:`~repro_torch.kernels.binarize_apply`)."""


def _wrappers() -> tuple:
    from repro_torch.kernels import binarize_apply, flat, hist2side, moments, pack

    return (*flat.WRAPPERS, *pack.WRAPPERS, hist2side.hist2side,
            moments.masked_moments, binarize_apply.binarize_apply)


def reset_launches() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper of the port."""
    return {fn.__name__: fn.launches for fn in _wrappers()}
