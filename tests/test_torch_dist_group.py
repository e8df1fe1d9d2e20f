"""The port's client group (``repro_torch.launch.mesh.ClientGroup``)
against the reference's collectives, on the CPU.

Two, three and four gloo ranks (one process each, a ``file://`` store)
gather and average the same rows that the reference's ``psum`` and
``pmean`` take over as many forced host devices inside ``shard_map``
(one process, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``).
The rows include columns whose f32 sum depends on the order of the adds
(``1e8 + 1 − 1e8 + 1`` is 1 left to right and 0 as a pairwise tree) and,
at three clients, values where ``sum / 3`` and ``sum · (1/3)`` differ
(under ``jit``, as the reference's train step always runs, XLA turns
``pmean``'s division by n into the product with the f32 1/n).

Four ranks also take two client axes ("pod", "data") = (2, 2): one
``pmean`` and one ``all_gather`` an axis, "pod" first, as the reference's
channel takes them on the (2, 2, 2) layout in data mode.

Tolerance: none.  ``pmean`` is bit for bit the reference's; the gathers
return every rank's rows in rank order (two axes: in the reference's
gathered order), bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import ClientGroup, make_host_group
from torch_dist_cases import finish, load_outputs, make_inputs, start_port, start_reference

WORLDS = (2, 3, 4)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("group")
    inp = tmp / "inputs.npz"
    make_inputs(inp, max(WORLDS), group=True)
    procs = [start_reference(tmp, inp, max(WORLDS))]
    for w in WORLDS:
        procs += start_port(tmp, inp, w, tag=f"port{w}")
    finish(procs, timeout=300)
    with np.load(inp) as z:
        x = {k: z[k] for k in ("g/x", "g/words", "g/pos")}
    ref, _ = load_outputs(tmp, "ref")
    ports = {w: load_outputs(tmp, f"port{w}", w)[0] for w in WORLDS}
    return x, ref, ports


def u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("w", WORLDS)
def test_pmean_is_the_references_bit_for_bit(outputs, w):
    x, ref, ports = outputs
    for r in range(w):
        np.testing.assert_array_equal(u32(ports[w][r]["g/pmean"]), u32(ref[f"g/{w}/pmean"][r]),
                                      err_msg=f"rank {r} of {w}")


@pytest.mark.parametrize("w", WORLDS)
def test_all_gather_rows_in_rank_order(outputs, w):
    x, _, ports = outputs
    for r in range(w):
        np.testing.assert_array_equal(u32(ports[w][r]["g/rows"]), u32(x["g/x"][:w]))
        np.testing.assert_array_equal(ports[w][r]["g/words"], x["g/words"][:w])
        assert ports[w][r]["g/words"].dtype == np.uint32
        np.testing.assert_array_equal(ports[w][r]["g/pos"], x["g/pos"][:w])


def test_the_rows_are_order_sensitive(outputs):
    """The inputs tell the orders apart: the reference's sum is the
    left-to-right one, not a pairwise tree, and at three clients its
    jitted mean is the product with the f32 1/3, which is not the
    division by 3."""
    x, ref, _ = outputs
    rows = x["g/x"]
    left = rows[0] + rows[1] + rows[2] + rows[3]
    tree = (rows[0] + rows[1]) + (rows[2] + rows[3])
    np.testing.assert_array_equal(u32(ref["g/4/psum"][0]), u32(left))
    assert (u32(left) != u32(tree)).sum() >= 4
    s3 = rows[0] + rows[1] + rows[2]
    third = s3 * (np.float32(1) / np.float32(3))
    np.testing.assert_array_equal(u32(ref["g/3/pmean"][0]), u32(third))
    assert (u32(s3 / np.float32(3)) != u32(third)).sum() >= 4


def test_host_group_is_the_identity():
    group = make_host_group("cpu")
    assert (group.rank, group.world, group.backend) == (0, 1, None)
    t = torch.tensor([-0.0, 1.5, 3.0])
    assert group.pmean(t) is t
    rows = group.all_gather_rows(t)
    assert tuple(rows.shape) == (1, 3) and torch.equal(rows[0], t)
    group.close()  # no process group: nothing to leave


def test_group_rejects_what_it_cannot_be():
    with pytest.raises(ValueError, match="world 1 and rank 0"):
        ClientGroup(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="outside a world"):
        ClientGroup(rank=3, world=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors only"):
        ClientGroup.connect(rank=0, world=1, device="cpu", backend="nccl")


def test_pod_clients_and_model_axes_belong_to_a12():
    """``client_mode="pod"`` and a "model" axis larger than 1 (ROADMAP A12,
    part 3, item 6) run: pod mode at world 1 is one client with one shard
    on the default layout, as in the reference, and a space of two devices
    a client compresses both in one pass.  A world of the layout's clients
    or of its devices (item 7: one rank a device) returns the client count,
    here 1 client over 4 device ranks; any other world raises
    ``ValueError``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.flat import ShardedFlatParamSpace
    from repro_torch.launch.dist import build_dist_train, client_topology
    from repro_torch.launch.mesh import check_clients

    pod = dataclasses.replace(get_config("lenet5"), client_mode="pod", img_size=12)
    assert client_topology(pod, {"data": 1, "model": 1}) == (1, ())
    assert client_topology(pod, {"pod": 2, "data": 16, "model": 16}) == (2, ("pod",))
    assert client_topology(get_config("lenet5"), {"pod": 2, "data": 2, "model": 2}) == (
        4, ("pod", "data"))
    fns = build_dist_train(pod, sparsity=0.01, device="cpu")
    assert fns.channel.n_clients == 1 and fns.channel.client_axes == ()
    assert all(gl.n_shards == 1 for gl in fns.channel.leaves)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.standard_normal((1, 4, 12, 12, 1)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, (1, 4)))}
    state, m = fns.train_step(fns.init_state(torch.Generator().manual_seed(0)), batch)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="one client a rank"):
        check_clients({"data": 2, "model": 1}, ("data",), 1)
    assert check_clients({"data": 2, "model": 2}, (), 4) == 1
    with pytest.raises(ValueError, match="one device a rank"):
        check_clients({"data": 2, "model": 2}, (), 2)
    space = ShardedFlatParamSpace.build(
        [dict(path="w", shape=(64,), rows=1, kind="sparse", rate=0.1, n_shards=2,
              global_size=128, grid=(2,), dev_block=(0, 1))],
        client_axes=("data",), shard_axes=("model",), n_clients=1, shards_per_client=2,
        group=make_host_group("cpu"))
    x = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    mean, own, _ = space.exchange_local([x], None)
    assert tuple(own.shape) == (2, space.n_pad)
    for d in range(2):  # each device's 64 entries: k = 6 survivors and one μ
        nz = own[d, :64][own[d, :64] != 0]
        assert nz.numel() == 6 and torch.unique(nz).numel() == 1
        assert torch.equal(own[d, :64], space.unflatten_local(own)[0][64 * d:64 * (d + 1)])


def test_two_client_axes_are_the_references(outputs):
    """``pmean(t, grid=(2, 2))`` and the rows in ``gather_order((2, 2))``
    equal the reference's per-axis ``pmean`` and nested ``all_gather`` on a
    ("pod", "data") = (2, 2) mesh, bit for bit; the gathered order is not
    rank order."""
    x, ref, ports = outputs
    for r in range(4):
        np.testing.assert_array_equal(ports[4][r]["g/2x2/pmean"].view(np.uint32),
                                      ref["g/2x2/pmean"][r].view(np.uint32))
        np.testing.assert_array_equal(ports[4][r]["g/2x2/gathered"],
                                      ref["g/2x2/gathered"][r])
    assert make_host_group("cpu").gather_order() == [0]
    assert not np.array_equal(ref["g/2x2/gathered"][0], x["g/x"][:4])
