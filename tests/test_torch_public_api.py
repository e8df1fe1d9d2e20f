"""The port's public surface against the JAX package's (ROADMAP A14):
every public top-level name of every module of ``src/repro/`` (read with
``ast``: functions, classes, assignments and ``__all__`` entries, not
imports) exists in the port's module of the same path, every public
member of the reference's classes exists on the port's class of that
name, and every ``__all__`` of the port covers the reference's.  The
names that mean nothing outside JAX and XLA are listed in
:data:`JAX_ONLY`, each with its reason; each public function's
parameters are the reference's, by name, but those on
:data:`ARGUMENTS` (JAX's and XLA's own, and a few renamed), each with its
reason.  Importing the port loads no JAX.
"""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"

# (module path under repro/, name) -> why the port has no counterpart
JAX_ONLY = {
    ("core/flat.py", "on_tpu"): "picks Pallas or the XLA lowering on a TPU; the port's "
                                "wrappers pick by the tensor's device",
    ("kernels/ops.py", "on_tpu"): "the same TPU test, in the kernels' API",
    ("launch/mesh.py", "make_host_mesh"): "a jax Mesh of forced host devices; the port's "
                                          "layout is a dict of axis sizes and its ranks a "
                                          "ClientGroup (make_host_group)",
    ("launch/mesh.py", "make_production_mesh"): "a jax Mesh of 256 or 512 devices; the port "
                                                "has production_layout()",
    ("launch/dryrun.py", "make_production_mesh"): "imported there from launch/mesh.py",
    ("launch/dist.py", "stacked_specs"): "PartitionSpecs of the stacked client state for "
                                         "jit's shardings; a port rank holds its own rows",
    ("launch/dist.py", "opt_state_specs"): "PartitionSpecs of the optimizer state, as above",
    ("launch/roofline.py", "cost_dict"): "reads XLA's compiled cost analysis; the port "
                                         "counts a step's FLOPs and bytes on meta tensors",
    ("launch/roofline.py", "parse_collectives"): "parses the collectives out of XLA's HLO "
                                                 "text; the port records them as they run",
    ("scale/planner.py", "PEAK_FLOPS"): "one TPU peak; the port has peak_flops(dtype), the "
                                        "H100's by dtype",
    ("launch/dist.py", "DistTrainFns.abstract_state"): "jax.eval_shape's ShapeDtypeStructs "
                                                       "for lowering without arrays",
    ("launch/dist.py", "DistTrainFns.batch_shardings"): "jit in_shardings of the batch; a "
                                                        "port rank takes its own rows",
    ("launch/dist.py", "DistTrainFns.state_shardings"): "jit in_shardings of the state",
    ("launch/dist.py", "DistServeFns.param_shardings"): "jit in_shardings of the params; "
                                                        "a port rank holds its blocks",
    ("launch/dist.py", "DistServeFns.cache_shardings"): "jit in_shardings of the caches "
                                                        "(the port cuts them by cache_specs)",
    ("launch/dist.py", "DistPrefillFns.param_shardings"): "jit in_shardings of the params",
    ("launch/dist.py", "DistPrefillFns.batch_shardings"): "jit in_shardings of the batch",
    ("run/build.py", "GspmdRun.mesh"): "the jax Mesh the run was built on; the port's run "
                                       "holds its ClientGroup (group) and its layout in fns",
}


# a parameter of a reference function that the port's function of the same
# name does not take, (module path, function, parameter) -> why
ARGUMENTS = {
    **{(rel, fn, "interpret"): "runs the Pallas kernel in JAX's interpreter on the CPU; a "
                               "port wrapper takes its plain version when its tensors are "
                               "on the CPU"
       for rel, fn in [("kernels/binarize_apply.py", "binarize_apply"),
                       ("kernels/flat.py", "seg_hist2side"), ("kernels/flat.py", "seg_moments"),
                       ("kernels/flat.py", "seg_binarize_apply"),
                       ("kernels/hist2side.py", "hist2side"),
                       ("kernels/moments.py", "masked_moments"),
                       ("kernels/ops.py", "threshold_two_pass"),
                       ("kernels/ops.py", "sbc_compress_hist"),
                       ("kernels/pack.py", "seg_packbits"), ("kernels/pack.py", "pack_bit_rows"),
                       ("kernels/pack.py", "seg_select_pack"),
                       ("kernels/pack.py", "golomb_decode_rows")]},
    **{(rel, fn, "mesh"): "a jax Mesh; the port takes the layout as a dict of axis sizes "
                          "(mesh_shape or layout) and its ranks as a ClientGroup (group)"
       for rel, fn in [("launch/dist.py", "client_topology"), ("launch/dist.py", "make_dist_train"),
                       ("launch/dist.py", "build_dist_train"), ("launch/dist.py", "cache_specs"),
                       ("launch/dist.py", "make_dist_serve"),
                       ("launch/dist.py", "make_dist_prefill"), ("launch/dryrun.py", "lower_pair"),
                       ("launch/mesh.py", "axis_sizes"), ("models/model.py", "make_param_specs")]},
    **{(rel, fn, "rng"): "a threefry key; the port draws from a torch.Generator (gen), "
                         "whose numbers differ, so parity tests hand the reference's draws "
                         "across"
       for rel, fn in [("models/attention.py", "init_attention"), ("models/cnn.py", "init_lenet5"),
                       ("models/cnn.py", "init_resnet32"), ("models/layers.py", "init_dense"),
                       ("models/layers.py", "init_embed"), ("models/layers.py", "init_mlp"),
                       ("models/lstm.py", "init_lstm_cell"), ("models/lstm.py", "init_lstm_lm"),
                       ("models/moe.py", "init_moe"), ("models/ssm.py", "init_mamba"),
                       ("models/ssm.py", "init_rwkv6"), ("models/transformer.py", "init_block"),
                       ("models/transformer.py", "init_stack"),
                       ("models/transformer.py", "init_decoder_lm")]},
    ("kernels/pack.py", "seg_packbits", "bits_pl"): "the same bit planes, named planes (no "
                                                    "Pallas memory space to mark)",
    ("launch/dist.py", "cache_specs", "a_caches"): "jax.eval_shape's abstract caches; the "
                                                   "port takes the caches (meta tensors "
                                                   "serve) as caches",
    ("launch/roofline.py", "analyze", "compiled"): "an XLA executable whose cost analysis it "
                                                   "reads; the port's takes a StepCounter and "
                                                   "CollectiveStats counted as the step ran",
    ("launch/roofline.py", "analyze", "pod_group_size"): "sorts HLO collectives into pods; "
                                                         "the port's CollectiveStats has them",
    ("launch/roofline.py", "analyze", "scan_trips"): "scales an HLO scan body's costs; the "
                                                     "port counts every trip (or samples "
                                                     "them: LoopSampler)",
    ("models/cnn.py", "conv", "p"): "the same HWIO kernel, named w_hwio",
    ("models/cnn.py", "conv", "padding"): "every reference call takes the default SAME; the "
                                          "port pads as XLA's SAME always",
    ("models/lstm.py", "init_lstm_cell", "dtype"): "every reference call takes the default "
                                                   "f32, the port's only dtype",
}


def _public(names) -> set:
    return {n for n in names if not n.startswith("_")}


def ref_names(path: Path) -> set:
    """A module's public top-level names: defs, classes, assignments and
    ``__all__`` entries."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for tg in node.targets:
                if isinstance(tg, ast.Name):
                    out.add(tg.id)
                    if tg.id == "__all__":
                        out |= {e.value for e in node.value.elts}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return _public(out)


def ref_members(path: Path) -> dict:
    """Each top-level class's public methods and fields."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            names = set()
            for b in node.body:
                if isinstance(b, ast.FunctionDef):
                    names.add(b.name)
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    names.add(b.target.id)
            out[node.name] = _public(names)
    return out


def port_members(cls) -> set:
    names = set(dir(cls))
    for base in cls.__mro__:
        names |= set(getattr(base, "__annotations__", {}))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names | set(getattr(cls, "_fields", ()))


def module_name(rel: Path) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch"] + parts)


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    port = importlib.import_module(module_name(Path(rel)))
    missing = sorted(n for n in ref_names(REF / rel)
                     if not hasattr(port, n) and (rel, n) not in JAX_ONLY)
    assert not missing, f"repro/{rel}: no counterpart in {port.__name__}: {missing}"
    members = []
    for cls, names in ref_members(REF / rel).items():
        if not hasattr(port, cls):
            continue  # a JAX-only class, listed above
        have = port_members(getattr(port, cls))
        members += [f"{cls}.{n}" for n in sorted(names - have)
                    if (rel, f"{cls}.{n}") not in JAX_ONLY]
    assert not members, f"repro/{rel}: members missing in {port.__name__}: {members}"
    ref_all = next((ast.literal_eval(node.value) for node in ast.parse((REF / rel).read_text())
                    .body if isinstance(node, ast.Assign)
                    and any(getattr(t, "id", "") == "__all__" for t in node.targets)), None)
    if ref_all is not None:
        assert set(ref_all) <= set(getattr(port, "__all__", ())), \
            f"{port.__name__}.__all__ lacks {sorted(set(ref_all) - set(port.__all__))}"


@pytest.mark.parametrize("rel", MODULES)
def test_every_parameter_has_a_counterpart(rel):
    """Each public function's parameters, by name, in the port's function
    of that name, or on :data:`ARGUMENTS`."""
    import inspect

    port = importlib.import_module(module_name(Path(rel)))
    missing = []
    for node in ast.parse((REF / rel).read_text()).body:
        if not isinstance(node, ast.FunctionDef) or node.name.startswith("_") \
                or not hasattr(port, node.name):
            continue
        have = set(inspect.signature(getattr(port, node.name)).parameters)
        missing += [f"{node.name}({a.arg})" for a in node.args.args + node.args.kwonlyargs
                    if a.arg not in have and (rel, node.name, a.arg) not in ARGUMENTS]
    assert not missing, f"repro/{rel}: parameters missing in {port.__name__}: {missing}"


def test_every_jax_only_name_is_the_references_and_absent_from_the_port():
    """The list names no name the reference lacks, and none the port has."""
    for (rel, name), why in JAX_ONLY.items():
        assert why
        cls, _, member = name.rpartition(".")
        if cls:
            assert member in ref_members(REF / rel)[cls], (rel, name)
            port = getattr(importlib.import_module(module_name(Path(rel))), cls)
            assert member not in port_members(port), (rel, name)
        else:
            text = (REF / rel).read_text()
            assert name in ref_names(REF / rel) or f"import {name}" in text \
                or f" {name}," in text or f" {name}\n" in text, (rel, name)
            assert not hasattr(importlib.import_module(module_name(Path(rel))), name), \
                (rel, name)
    for (rel, fn, arg), why in ARGUMENTS.items():
        import inspect

        assert why
        ref_fn = next(node for node in ast.parse((REF / rel).read_text()).body
                      if isinstance(node, ast.FunctionDef) and node.name == fn)
        assert arg in [a.arg for a in ref_fn.args.args + ref_fn.args.kwonlyargs], (rel, fn, arg)
        port_fn = getattr(importlib.import_module(module_name(Path(rel))), fn)
        assert arg not in inspect.signature(port_fn).parameters, (rel, fn, arg)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.run, repro_torch.optim, "
            "repro_torch.launch.train, repro_torch.launch.fed; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
