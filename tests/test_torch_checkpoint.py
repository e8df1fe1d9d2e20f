"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

  * the local half of ``tests/test_checkpoint_resume.py``: a local run
    saved after round 2, restored and continued is bit for bit the run
    that never stopped (params, optimizer and compressor state, round,
    ledger), on the flat residual (``fast=True``) and the per-leaf one;
  * the layout is the reference's: the reference's ``load_pytree`` reads
    the port's parameters and optimizer state, and the port's reads the
    reference's, bit for bit; bf16 leaves round-trip;
  * a checkpoint of another structure or shape is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_pytree as j_load_pytree
from repro.checkpoint.io import save_pytree as j_save_pytree
from repro.optim.optimizers import AdamState as JAdamState
from repro_torch.checkpoint import (
    load_pytree,
    restore_train_state,
    save_pytree,
    save_train_state,
)
from repro_torch.run import RunSpec, build_run
from torch_helpers import n, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def assert_same(a, b, what=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}/{i}")
    else:
        x, y = np.asarray(n(a)), np.asarray(n(b))
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert x.tobytes() == y.tobytes(), what


@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_local_resume_mid_run_is_bit_identical(tmp_path, fast):
    spec = RunSpec(preset="lenet5", backend="local", clients=2, batch=4, sparsity=0.01,
                   measure_wire=True, fast=fast)
    straight, resumed = build_run(spec, device="cpu"), build_run(spec, device="cpu")
    state = straight.init()
    for r in range(4):
        state, _ = straight.step(state, r)
    mid = resumed.init()
    for r in range(2):
        mid, _ = resumed.step(mid, r)
    path = str(tmp_path / "ckpt.npz")
    resumed.checkpoint(mid, path)
    back = restore_train_state(path, resumed.init())
    assert_same(back._asdict(), mid._asdict(), "restored")
    for r in range(2, 4):
        back, _ = resumed.step(back, r)
    assert_same(back._asdict(), state._asdict(), "resumed")
    assert resumed.ledger.history() == straight.ledger.history()


def test_reference_reads_the_port_params_and_optimizer_state(tmp_path):
    run = build_run(RunSpec(preset="lenet5", backend="local", clients=2, batch=4), device="cpu")
    state, _ = run.step(run.init(), 0)
    save_pytree(str(tmp_path / "params.npz"), state.params)
    save_pytree(str(tmp_path / "opt.npz"), state.opt_states)
    like = {k: jnp.zeros(v.shape, jnp.float32) for k, v in state.params.items()}
    got = j_load_pytree(str(tmp_path / "params.npz"), like)
    for k, v in state.params.items():
        assert np.asarray(got[k]).tobytes() == n(v).tobytes()
    like_opt = JAdamState(*({k: jnp.zeros(v.shape, jnp.float32) for k, v in part.items()}
                            for part in state.opt_states))
    got = j_load_pytree(str(tmp_path / "opt.npz"), like_opt)
    for j_part, t_part in zip(got, state.opt_states):
        for k, v in t_part.items():
            assert np.asarray(j_part[k]).tobytes() == n(v).tobytes()


def test_port_reads_the_reference_checkpoint(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "nest": {"b": rng.standard_normal(5).astype(np.float32),
                     "h": jnp.asarray(rng.standard_normal(6), jnp.bfloat16)},
            "step": np.int32(7)}
    path = str(tmp_path / "ref.npz")
    j_save_pytree(path, jax.tree.map(jnp.asarray, tree))
    like = {"w": torch.zeros(3, 4), "nest": {"b": torch.zeros(5),
                                             "h": torch.zeros(6, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}
    got = load_pytree(path, like)
    assert n(got["w"]).tobytes() == tree["w"].tobytes()
    assert n(got["nest"]["b"]).tobytes() == tree["nest"]["b"].tobytes()
    assert got["nest"]["h"].dtype == torch.bfloat16
    assert (got["nest"]["h"].view(torch.int16).numpy().tobytes()
            == np.asarray(tree["nest"]["h"]).view(np.uint16).tobytes())
    assert int(got["step"]) == 7
    assert sorted(load_pytree(path)) == ["nest/b", "nest/h", "step", "w"]


def test_bf16_round_trips_and_the_reference_reads_it(tmp_path):
    x = torch.randn(9, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    path = str(tmp_path / "bf16.npz")
    save_pytree(path, {"x": x})
    assert torch.equal(load_pytree(path, {"x": torch.zeros(9, dtype=torch.bfloat16)})["x"], x)
    got = j_load_pytree(path)["x"]
    assert got.dtype == jnp.bfloat16
    assert np.asarray(got).view(np.uint16).tobytes() == x.view(torch.int16).numpy().tobytes()


def test_restore_rejects_mismatched_structure(tmp_path):
    path = str(tmp_path / "p.npz")
    save_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="mismatch"):
        load_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(path, {"a": torch.zeros(4), "b": torch.zeros(2)})
