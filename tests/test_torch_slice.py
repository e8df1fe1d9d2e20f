"""The port's slice as a whole — LeNet5 DSGD rounds through the GSPMD
backend's flat hist engine — against the JAX package, plus the rules the
port keeps (no JAX at run time, no silent fall back, no silent other path).

The parity runs use LeNet5 at ``img_size=12`` for speed, build the JAX
side on an explicit one-device mesh (``jax.devices()[:1]``, so the test
holds under forced host devices too), and start both from the same
carried-across state and numpy batches.

Why the carried-across Adam state is warm (drawn from a seed) and not the
reference's zeros: the reference applies Adam with ``step=0`` every round,
so from zero moments every |ΔW| is ≈ lr and each segment's μ⁺ and μ⁻ tie
to the last few ulps.  Which side wins is then decided by rounding noise,
in either package alone.  From a warm state the sides are well apart and
the comparison measures the port, not the tie.

Tolerances: round-1 loss ``rtol=1e-5``; three-round loss ``rtol=1e-4``;
μ ``rtol=1e-5``; survivor counts and selection masks may differ only at
entries next to a histogram bucket edge (see ``torch_helpers``).
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import get_config as j_get_config
from repro.core.channel import ShardedGspmdChannel as JShardedGspmdChannel
from repro.core.flat import _hist_pipeline as j_hist_pipeline
from repro.kernels.flat import seg_hist2side as j_seg_hist2side
from repro.kernels.hist2side import SPAN_OCTAVES
from repro.kernels.hist2side import bucket_lower_edges as j_bucket_lower_edges
from repro.kernels.ops import _side_threshold as j_side_threshold
from repro.launch.dist import build_dist_train as j_build_dist_train
from repro.models.model import build_model as j_build_model
from repro.optim.optimizers import AdamState as JAdamState
from repro.optim.optimizers import get_optimizer as j_get_optimizer
from repro.run.flags import build_parser as j_build_parser
from repro.run.spec import RunSpec as JRunSpec
from repro_torch.configs.base import get_config
from repro_torch import kernels
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core.channel import ShardedGspmdChannel
from repro_torch.core.flat import _hist_pipeline as t_hist_pipeline
from repro_torch.data import make_classification_task
from repro_torch.kernels import flat as tflat
from repro_torch.kernels.flat import seg_absmax
from repro_torch.launch.dist import build_dist_train
from repro_torch.launch.mesh import make_host_group
from repro_torch.run import RunSpec, build_parser, build_preset, build_run
from torch_helpers import n, near_edge_mask, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = pathlib.Path(__file__).resolve().parent.parent
SLICE = dict(preset="lenet5", backend="gspmd", fast=True, flat_engine="hist",
             sparsity=0.01)


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def pair():
    """(jax fns, port fns, jax state, port state) at img_size=12, from one
    warm carried-across state."""
    jcfg = dataclasses.replace(j_get_config("lenet5"), img_size=12)
    jfns = j_build_dist_train(jcfg, one_device_mesh(), compressor="sbc",
                              sparsity=0.01, fast=True, flat_engine="hist")
    tfns = build_dist_train(dataclasses.replace(get_config("lenet5"), img_size=12),
                            sparsity=0.01, fast=True, flat_engine="hist", device="cpu")
    jstate = jfns.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(42)
    jstate["opt"] = JAdamState(
        jax.tree.map(lambda m: jnp.asarray(0.01 * rng.standard_normal(m.shape),
                                           jnp.float32), jstate["opt"].m),
        jax.tree.map(lambda v: jnp.asarray((0.01 * rng.standard_normal(v.shape)) ** 2,
                                           jnp.float32), jstate["opt"].v),
    )
    np_state = jax.tree.map(np.asarray, jstate)
    return jcfg, jfns, tfns, np_state


def batches(rounds, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal((1, 16, 12, 12, 1)).astype(np.float32),
             "labels": rng.integers(0, 10, (1, 16)).astype(np.int32)}
            for _ in range(rounds)]


def j_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def t_batch(b):
    return {"images": t(b["images"]), "labels": t(b["labels"]).long()}


def test_three_rounds_match_jax(pair):
    _, jfns, tfns, np_state = pair
    jstate = jax.tree.map(jnp.asarray, np_state)
    tstate = state_from_jax(np_state, device="cpu")
    for r, b in enumerate(batches(3)):
        jstate, jm = jfns.train_step(jstate, j_batch(b))
        tstate, tm = tfns.train_step(tstate, t_batch(b))
        rtol = 1e-5 if r == 0 else 1e-4
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=rtol,
                                   err_msg=f"round {r + 1}")
    assert tfns.bits_per_client == jfns.bits_per_client
    assert tfns.bits_dense == jfns.bits_dense
    for k, v in tstate["params"].items():
        np.testing.assert_allclose(n(v), n(jstate["params"][k]), rtol=1e-4, atol=1e-6)


def _jax_pass_ranges(space, acc, nbins=128):
    """Per pass, the per-segment ``(lo⁺, hi⁺, lo⁻, hi⁻)`` ranges the JAX
    pipeline bins in (coarse pass, then the zoomed pass)."""
    bounds = [(s.offset, s.n_loc) for s in space.segments]
    absmax = jnp.stack([jnp.max(jnp.abs(acc[o:o + k])) for o, k in bounds]) + 1e-30
    lo0, hi0 = absmax * 2.0 ** -SPAN_OCTAVES, absmax * 1.0001
    sob = space.seg_of_block
    params = jnp.stack([jnp.asarray(sob, jnp.float32), lo0[sob], hi0[sob],
                        lo0[sob], hi0[sob]], axis=1)
    h1 = j_seg_hist2side(acc.reshape(-1, 128), params, nseg=len(bounds), nbins=nbins)
    edges0 = jax.vmap(lambda lo, hi: j_bucket_lower_edges(lo, hi, nbins))(lo0, hi0)
    kf = jnp.asarray([s.k for s in space.segments], jnp.float32)
    lo_p, hi_p, _ = jax.vmap(j_side_threshold)(h1[:, 0], edges0, kf)
    lo_n, hi_n, _ = jax.vmap(j_side_threshold)(h1[:, 1], edges0, kf)
    return [tuple(map(np.asarray, (lo0, hi0, lo0, hi0))),
            tuple(map(np.asarray, (lo_p, hi_p, lo_n, hi_n)))]


def test_port_exchange_on_the_jax_round1_accumulator(pair):
    """JAX's round-1 accumulator through the port's exchange: the port
    selects what JAX selects, except next to a bucket edge."""
    jcfg, jfns, tfns, np_state = pair
    space = jfns.flat_space
    b = batches(1)[0]
    jmodel, jopt = j_build_model(jcfg), j_get_optimizer("adam")
    params = jax.tree.map(jnp.asarray, np_state["params"])
    opt0 = jax.tree.map(lambda x: jnp.asarray(x[0]), np_state["opt"])
    _, g = jax.value_and_grad(jmodel.loss_fn)(params, {k: v[0] for k, v in j_batch(b).items()})
    p2, _ = jopt.apply(opt0, g, params, jcfg.base_lr, jnp.zeros((), jnp.int32))
    bodies = [np.asarray(p2[k] - params[k]) for k in sorted(params)]
    res = np_state["residual"][0, 0]
    acc = jnp.asarray(res) + space.flatten_local([jnp.asarray(x) for x in bodies])

    bounds = [(s.offset, s.n_loc) for s in space.segments]
    ks = [s.k for s in space.segments]
    rates = [s.rate for s in space.segments]
    j_own, _, j_stats = j_hist_pipeline(acc, bounds, ks, rates, space.seg_of_block,
                                        space.n_blocks, 8, 128, 128, True)
    t_space = tfns.flat_space
    t_mean, t_own, t_res = t_space.exchange_local_hist([t(x) for x in bodies], t(res))
    _, _, t_stats = t_hist_pipeline(
        t(acc), bounds, ks, rates, torch.from_numpy(t_space.seg_of_block.astype(np.int64)),
        t_space.n_blocks, 8, 128, 128, absmax=seg_absmax(t(acc), bounds))
    np.testing.assert_array_equal(n(t_res), n(acc) - n(t_own))
    assert t_mean is t_own

    acc_np, j_sel, t_sel = n(acc), n(j_own) != 0, n(t_own) != 0
    ranges = _jax_pass_ranges(space, acc)
    for i, (o, k) in enumerate(bounds):
        x = acc_np[o:o + k]
        edge = np.zeros(k, bool)
        for lo_p, hi_p, lo_n, hi_n in ranges:
            edge |= near_edge_mask(x, lo_p[i], hi_p[i], 128, 0)
            edge |= near_edge_mask(x, lo_n[i], hi_n[i], 128, 1)
        differ = j_sel[o:o + k] != t_sel[o:o + k]
        assert not (differ & ~edge).any(), f"segment {i}: selection differs off the edges"
        assert abs(float(t_stats["count"][i]) - float(j_stats["count"][i])) <= edge.sum()
    np.testing.assert_allclose(n(t_stats["mu"]), n(j_stats["mu"]), rtol=1e-5)


# ---------------------------------------------------------------- discipline


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 20


def test_no_source_of_the_port_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card (this machine), or no checkout beside the script: exit 1
    and no result on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=120, cwd=script.parent)
        assert out.returncode == 1 and out.stdout == "", (script, out.stdout)
        assert "FAIL" in out.stderr


def test_build_run_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_run(RunSpec(**SLICE))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_preset("lenet5", batch=8, seq_len=64)


@pytest.mark.parametrize("entry", ["make_classification_task", "params_from_jax",
                                   "state_from_jax", "build_dist_train"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Every entry point that takes a device runs on the card unless the
    caller passes ``device="cpu"``: without a card it raises, never
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaf = {"w": np.ones((2, 3), np.float32)}
    call = {
        "make_classification_task": lambda **kw: make_classification_task(
            n_classes=10, img_size=4, channels=1, batch=2, **kw),
        "params_from_jax": lambda **kw: params_from_jax(leaf, **kw),
        "state_from_jax": lambda **kw: state_from_jax(
            {"params": leaf, "opt": (), "residual": np.zeros((1, 1, 8), np.float32)}, **kw),
        "build_dist_train": lambda **kw: build_dist_train(
            dataclasses.replace(get_config("lenet5"), img_size=12), sparsity=0.01, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()
    call(device="cpu")


# the baseline compressors and the wordlstm preset run now
# (tests/test_torch_baselines_run.py, tests/test_torch_wordlstm.py) and
# resnet32's preset raises the reference's ValueError
# (tests/test_torch_resnet32.py).  The fed broadcast_log cases run now
# (tests/test_torch_fed_broadcast.py), and so do the decoder presets' cases
# (tests/test_torch_decoder_run.py).  mixtral's reduced config builds
# (tests/test_torch_zoo_run.py), and as a pod-mode config it runs on gspmd
# now (ROADMAP A12, part 3, item 6): one client a pod, here one client
@pytest.mark.parametrize("change", [
    dict(flat_engine="exact", skip_pattern="f2", fast=False, preset="mixtral_8x7b"),
])
def test_specs_outside_the_slice_raise(change):
    """A spec that the port once refused as outside its slice (a pod-mode
    preset on gspmd) builds and runs a round: one client, the per-leaf
    exchange, a finite loss.  It raises nothing now."""
    spec =RunSpec(**{**SLICE, **change, "batch": 2, "seq_len": 8, "rounds": 1})
    run = build_run(spec, device="cpu")
    assert run.n_clients == 1 and run.channel.client_axes == () and run.fns.flat_space is None
    _, hist = run.run()
    assert np.isfinite(hist["loss"][0])


@pytest.fixture(scope="module")
def full_width_jax_bits():
    """The reference's Eq. 1 bits per client per round, LeNet5 at p = 0.01."""
    return j_build_dist_train(j_get_config("lenet5"), one_device_mesh(), compressor="sbc",
                              sparsity=0.01, fast=True).bits_per_client


@pytest.mark.parametrize("change", [
    dict(flat_engine="exact"), dict(measure_wire=True),
    dict(flat_engine="exact", device_pack=True),
    dict(fast=False, flat_engine="exact", measure_wire=True), dict(fast=False, flat_engine="exact"),
])
def test_specs_now_in_the_port_run_on_the_cpu(change, full_width_jax_bits):
    """Full-width LeNet5 on the CPU: finite losses, the reference's Eq. 1
    bits (102,035.46 a client a round), one ledger row a round when the
    wire is metered, and no kernel launch; the flat residual, or per leaf
    with ``fast=False``."""
    run = build_run(RunSpec(**{**SLICE, **change}, batch=8, rounds=2), device="cpu")
    kernels.reset_launches()
    state, hist = run.run()
    assert all(np.isfinite(hist["loss"])) and len(hist["loss"]) == 2
    assert run.fns.bits_per_client == full_width_jax_bits
    assert len(run.ledger.records) == (2 if run.spec.measure_wire else 0)
    assert set(kernels.launch_counts().values()) == {0}
    if run.spec.fast:
        assert tuple(state["residual"].shape) == (1, 1, 1_259_520)
    else:
        assert run.fns.flat_space is None and state["residual"]["f1"].shape == (1, 2450, 500)


def test_gspmd_channel_refuses_what_the_reference_refuses():
    """The channel's option checks raise the reference's ValueErrors with
    its messages; a spec with device_pack outside the exact engine is
    refused by RunSpec itself, as in the reference."""
    space = object()  # the checks only ask whether there is a flat space
    one = make_host_group("cpu")
    for kw in (dict(flat_space=space, flat_engine="hist", device_pack=True),
               dict(flat_space=None, flat_engine="hist"),
               dict(flat_space=None, flat_engine="exact", device_pack=True),
               dict(flat_space=space, flat_engine="topk")):
        with pytest.raises(ValueError) as want:
            JShardedGspmdChannel(leaves=(), client_axes=("data",), n_clients=1, **kw)
        with pytest.raises(ValueError) as got:
            ShardedGspmdChannel(leaves=(), client_axes=("data",), n_clients=1,
                                group=one, **kw)
        assert str(got.value) == str(want.value)
    # no flat space: the per-leaf exchange, as in the reference; more
    # clients than its group has ranks are refused
    assert ShardedGspmdChannel(leaves=(), client_axes=("data",), n_clients=1,
                               group=one).flat_space is None
    with pytest.raises(ValueError, match="need a ClientGroup of 2 ranks"):
        ShardedGspmdChannel(leaves=(), client_axes=("data",), n_clients=2, group=one)
    with pytest.raises(ValueError, match="device_pack"):
        RunSpec(**SLICE, device_pack=True)


def test_runspec_and_flags_copy_the_reference():
    jf = {f.name: f.default for f in dataclasses.fields(JRunSpec)}
    tf = {f.name: f.default for f in dataclasses.fields(RunSpec)}
    assert tf == jf
    spec = RunSpec(**SLICE, batch=128, rounds=5, profiles=((2, 0.01, 1.0),))
    assert RunSpec.from_json(spec.to_json()) == spec
    assert RunSpec.from_json(JRunSpec(**SLICE, batch=128).to_json()) == RunSpec(**SLICE, batch=128)
    with pytest.raises(ValueError, match="unknown RunSpec fields"):
        RunSpec.from_json('{"presett": "lenet5"}')

    def flags(ap):
        return {o for a in ap._actions for o in a.option_strings}

    assert flags(build_parser()) == flags(j_build_parser())


def test_full_size_cpu_rounds_use_the_plain_versions():
    """LeNet5 at full width (1,256,010 params) on the CPU: finite losses,
    the JAX package's Eq. 1 bits, and no kernel launch."""
    run = build_run(RunSpec(**SLICE, batch=8, rounds=2), device="cpu")
    jfns = j_build_dist_train(j_get_config("lenet5"), one_device_mesh(),
                              compressor="sbc", sparsity=0.01, fast=True,
                              flat_engine="hist")
    tflat.reset_launches()
    state, hist = run.run()
    assert all(np.isfinite(hist["loss"])) and len(hist["loss"]) == 2
    assert run.fns.bits_per_client == jfns.bits_per_client
    assert run.fns.bits_dense == jfns.bits_dense
    assert set(tflat.launch_counts().values()) == {0}
    assert tuple(state["residual"].shape) == (1, 1, 1_259_520)


@pytest.mark.parametrize("builder", ["DSGDTrainer", "build_dist_train", "ClientPool"])
def test_step_builders_turn_tf32_off(builder):
    """Every builder of a training step keeps f32 matmuls and convolutions
    in full f32 (cuDNN runs f32 convolutions in TF32 by default), so a
    library caller gets what ``build_run`` gives."""
    import warnings

    from repro_torch.core.api import make_compressor
    from repro_torch.fed import ClientPool
    from repro_torch.launch.dist import build_dist_train
    from repro_torch.models.model import build_model
    from repro_torch.optim import get_optimizer
    from repro_torch.train import DSGDTrainer

    cfg = get_config("lenet5")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        if builder == "DSGDTrainer":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                DSGDTrainer(model=build_model(cfg), compressor=make_compressor("sbc"),
                            optimizer=get_optimizer("adam"), n_clients=2, lr=lambda it: 0.1,
                            device="cpu")
        elif builder == "build_dist_train":
            build_dist_train(cfg, sparsity=0.01, device="cpu")
        else:
            ClientPool(model=None, optimizer=None, task=None, lr=lambda it: 0.1,
                       policy=make_compressor("sbc").policy, n_clients=2, device="cpu")
        assert not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_build_dist_train_defaults_keep_the_policys_flag():
    """``build_dist_train`` with its defaults takes the policy's own flag in
    both packages: the default ``sbc`` policy is per leaf, so both take the
    per-leaf exchange and keep a residual tree.  One round at lr 0 from a
    seeded residual (so ΔW is 0 in both and the accumulator is the
    residual, bit for bit) gives the reference's ΔW* and new residual, bit
    for bit."""
    jcfg = dataclasses.replace(j_get_config("lenet5"), img_size=12, base_lr=0.0)
    tcfg = dataclasses.replace(get_config("lenet5"), img_size=12, base_lr=0.0)
    jfns = j_build_dist_train(jcfg, one_device_mesh(), sparsity=0.01, measure=True)
    tfns = build_dist_train(tcfg, sparsity=0.01, measure=True, device="cpu")
    assert jfns.flat_space is None and tfns.flat_space is None
    assert jfns.residual_to_tree is None and tfns.residual_to_tree is None
    jstate = jfns.init_state(jax.random.PRNGKey(0))
    assert isinstance(jstate["residual"], dict)
    assert isinstance(tfns.init_state(torch.Generator().manual_seed(0))["residual"], dict)
    rng = np.random.default_rng(7)
    jstate["residual"] = jax.tree.map(
        lambda x: jnp.asarray(0.01 * rng.standard_normal(x.shape), jnp.float32),
        jstate["residual"])
    np_state = jax.tree.map(np.asarray, jstate)
    tstate = state_from_jax(np_state, device="cpu")
    assert isinstance(tstate["residual"], dict)
    b = batches(1)[0]
    b = {"images": b["images"][:, :, :12, :12], "labels": b["labels"]}
    jstate, jm = jfns.train_step(jstate, j_batch(b))
    tstate, tm = tfns.train_step(tstate, {"images": t(b["images"]),
                                          "labels": t(b["labels"]).long()})
    for k, v in jm["own_client0"].items():
        np.testing.assert_array_equal(n(tm["own_client0"][k]).view(np.uint32),
                                      n(v).view(np.uint32), err_msg=f"dW* {k}")
        np.testing.assert_array_equal(n(tstate["residual"][k]).view(np.uint32),
                                      n(jstate["residual"][k]).view(np.uint32),
                                      err_msg=f"residual {k}")
        assert n(v).any()
