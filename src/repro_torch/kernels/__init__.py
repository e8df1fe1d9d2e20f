"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version beside the wrapper (:mod:`repro_torch.kernels.flat`)."""
