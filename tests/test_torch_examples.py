"""The port's examples run on the CPU (``--device cpu``) and self-assert:
``examples/torch_quickstart.py`` (the codec, policy and wire walk) and
``examples/torch_federated_wire.py`` (real SBW1 bytes both ways, two
rounds here; ten by default).  The other three, and these at their
defaults, run on the card in ``chip_smoke.py`` phase 19d."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = {
    "torch_quickstart": ([], ["receiver reconstruction matches ✓",
                              "residual + transmitted == full update ✓"]),
    "torch_federated_wire": (["--rounds", "2"], ["reconcile with Eq. 1/Eq. 5 ✓"]),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    argv, marks = EXAMPLES[name]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                          "--device", "cpu", *argv], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    for mark in marks:
        assert mark in out.stdout, out.stdout[-2000:]
