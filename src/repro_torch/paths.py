"""The repository root and its output directories.

Counterpart of ``repro.paths``: the root is found structurally (the
directory that holds ``src/repro_torch``), walking up from this file, so
the helpers work from a test process, an installed ``src`` layout, or a
launcher run from any working directory.

    from repro_torch.paths import experiments_dir
    OUT_DIR = experiments_dir("dryrun_torch")
"""
from __future__ import annotations

import os


def repo_root() -> str:
    """Absolute path of the repository root (the directory holding ``src/``)."""
    here = os.path.dirname(os.path.abspath(__file__))  # .../src/repro_torch
    cand = os.path.dirname(os.path.dirname(here))
    if os.path.isdir(os.path.join(cand, "src", "repro_torch")):
        return cand
    cur = here
    while True:
        parent = os.path.dirname(cur)
        if parent == cur:
            return cand  # the filesystem root: best effort
        if os.path.isdir(os.path.join(parent, "src", "repro_torch")):
            return parent
        cur = parent


def experiments_dir(*parts: str, create: bool = False) -> str:
    """``<repo>/experiments/<parts...>`` (made with ``create``)."""
    path = os.path.join(repo_root(), "experiments", *parts)
    if create:
        os.makedirs(path, exist_ok=True)
    return path
