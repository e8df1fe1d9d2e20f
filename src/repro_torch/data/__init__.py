"""Synthetic data of the port."""
from repro_torch.data.synthetic import (
    Task,
    client_batches,
    make_classification_task,
    make_lm_task,
    make_non_iid_lm_task,
    split_among_clients,
)

__all__ = ["Task", "client_batches", "make_classification_task", "make_lm_task",
           "make_non_iid_lm_task", "split_among_clients"]
