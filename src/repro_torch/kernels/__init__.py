"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside the wrapper (:mod:`repro_torch.kernels.flat`,
:mod:`repro_torch.kernels.pack`)."""


def reset_launches() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    from repro_torch.kernels import flat, pack

    flat.reset_launches()
    pack.reset_launches()


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper of the port."""
    from repro_torch.kernels import flat, pack

    return {**flat.launch_counts(), **pack.launch_counts()}
