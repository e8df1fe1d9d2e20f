"""The port's exact flat engine and its device-packed wire against the JAX
package, on the CPU.

``ShardedFlatParamSpace.exchange_local`` of both packages gets the same
accumulator (made with numpy from a seed).  With one client the
reference's function runs outside ``shard_map``: its ``all_gather`` is
skipped, and with ``client_axes=()`` so is the ``pmean`` of dense
segments.  Its Pallas ``seg_packbits`` runs in interpret mode.

Tolerances:
  * selected positions, packed words and bit counts: bit-exact, ties and
    ±0 included (the port ranks on total-order integer keys with a stable
    sort, as ``lax.top_k`` orders);
  * μ, ΔW*, the residual and the side chosen: bit-exact.  Both packages
    take each side's mean in XLA's f32 order (the port through
    ``repro_torch.kernels.reduce.f32_mean_xla``);
  * the slice over three rounds from a warm carried-across state (see
    ``test_torch_slice.py`` for why warm): loss ``rtol=1e-5`` in round 1
    and ``1e-4`` after; the ledger's totals equal whenever the selections
    are equal, and the test allows 0 rounds whose selections differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import get_config as j_get_config
from repro.core.flat import ShardedFlatParamSpace as JSpace
from repro.launch.dist import build_dist_train as j_build_dist_train
from repro.optim.optimizers import AdamState as JAdamState
from repro_torch.configs.base import get_config
from repro_torch.convert import state_from_jax
from repro_torch.core import flat as tflat_core
from repro_torch.core.flat import ShardedFlatParamSpace as TSpace
from repro_torch.core.golomb import encode_positions_packed, packed_words_to_bytes
from repro_torch.kernels import pack as tpack
from repro_torch.launch.dist import build_dist_train
from repro_torch.launch.mesh import make_host_group
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

# (path, local shape, rows, kind, rate): ragged sizes, a scanned
# three-row segment, and one segment that selects every slot (k = n)
SPARSE = [
    ("a", (3, 7, 11), 1, "sparse", 0.01),
    ("b", (3, 400), 3, "sparse", 0.05),
    ("c", (2500,), 1, "sparse", 0.01),
    ("d", (9,), 1, "sparse", 0.5),
    ("e", (4,), 1, "sparse", 0.99),
]
MIXED = SPARSE[:3] + [("f", (70,), 1, "dense", 1.0), ("g", (33,), 1, "skip", 0.01)]


def spaces(layout, client_axes=("data",)):
    entries = [dict(path=p, shape=s, rows=r, kind=kd, rate=rate, n_shards=1,
                    global_size=int(np.prod(s))) for p, s, r, kd, rate in layout]
    kw = dict(client_axes=client_axes, shard_axes=("model",), n_clients=1,
              shards_per_client=1)
    return JSpace.build(entries, **kw), TSpace.build(entries, **kw, group=make_host_group("cpu"))


def bodies_for(layout, seed, kind="random"):
    rng = np.random.default_rng(seed)
    out = []
    for _, shape, _, _, _ in layout:
        if kind == "random":
            x = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))
        else:  # ties and ±0: few distinct values, zeros of both signs
            x = rng.choice(np.array([0.0, -0.0, 1.0, 1.0, 0.5, -0.25, -0.0]), size=shape)
        out.append(x.astype(np.float32))
    return out


def assert_exchange_equal(jout, tout, jspace, tspace):
    j_mean, j_own, j_res = jout[:3]
    t_mean, t_own, t_res = tout[:3]
    assert t_mean is t_own  # one client: the mean is the client's own ΔW*
    np.testing.assert_array_equal(n(t_own) != 0, n(j_own) != 0)
    np.testing.assert_array_equal(n(t_own).view(np.uint32), n(j_own).view(np.uint32))
    np.testing.assert_array_equal(n(t_mean).view(np.uint32), n(j_mean).view(np.uint32))
    if j_res is None:
        assert t_res is None
    else:
        np.testing.assert_array_equal(n(t_res).view(np.uint32), n(j_res).view(np.uint32))
    for s in tspace._sparse:
        own = n(t_own)[s.offset:s.offset + s.rows * s.n_loc].reshape(s.rows, s.n_loc)
        assert ((own != 0).sum(1) == s.k).all(), s.path


@pytest.mark.parametrize("layout,kind,client_axes,with_res", [
    (SPARSE, "random", ("data",), True),
    (SPARSE, "ties", ("data",), False),
    (MIXED, "random", (), True),
], ids=["sparse", "ties-and-signed-zeros", "dense-and-skip"])
@pytest.mark.parametrize("device_pack", [False, True], ids=["positions", "device-pack"])
def test_exchange_local_matches_jax(layout, kind, client_axes, with_res, device_pack):
    jspace, tspace = spaces(layout, client_axes)
    assert (tspace.n_mu, tspace.n_pos, tspace.n_pack_words) == (
        jspace.n_mu, jspace.n_pos, jspace.n_pack_words)
    assert tspace._pack_info == jspace._pack_info
    np.testing.assert_array_equal(tspace._pos_row, jspace._pos_row)
    np.testing.assert_array_equal(tspace._dense_idx, jspace._dense_idx)
    bodies = bodies_for(layout, seed=7, kind=kind)
    res = (np.random.default_rng(8).standard_normal(jspace.n_pad).astype(np.float32)
           * 0.1 if with_res else None)
    jout = jspace.exchange_local([jnp.asarray(b) for b in bodies],
                                 None if res is None else jnp.asarray(res),
                                 device_pack=device_pack, interpret=True)
    tout = tspace.exchange_local([t(b) for b in bodies], None if res is None else t(res),
                                 device_pack=device_pack)
    assert_exchange_equal(jout, tout, jspace, tspace)
    if res is not None:  # the port's residual is acc − ΔW*, bit for bit
        acc = t(res) + tspace.flatten_local([t(b) for b in bodies])
        assert torch.equal(tout[2], acc - tout[1])
    if device_pack:
        j_words, j_nbits = jout[3:]
        t_words, t_nbits = tout[3:]
        assert t_words.dtype == torch.uint32 and tuple(t_words.shape) == (tspace.n_pack_words,)
        np.testing.assert_array_equal(n(t_words), n(j_words))
        np.testing.assert_array_equal(n(t_nbits), n(j_nbits))
        # each (segment, row)'s stream is the host encoder's bytes, and the
        # fused select→pack gives the same words from the row's mask
        own, mu_row = n(tout[1]), 0
        for s, (b, w, off) in zip(tspace._sparse, tspace._pack_info):
            x = own[s.offset:s.offset + s.rows * s.n_loc].reshape(s.rows, s.n_loc)
            fw, fnb = tpack.seg_select_pack(t((x != 0).astype(np.int32)), k=s.k, bstar=b)
            for r in range(s.rows):
                row_words = n(t_words)[off + r * w:off + (r + 1) * w]
                nb = int(t_nbits[mu_row])
                host, host_nb = encode_positions_packed(np.flatnonzero(x[r]), s.rate)
                assert (packed_words_to_bytes(row_words, nb), nb) == (host, host_nb)
                np.testing.assert_array_equal(n(fw)[r], row_words)
                assert int(fnb[r]) == nb
                mu_row += 1


def test_top_k_orders_ties_and_signed_zeros_as_lax():
    x = np.array([0, -0.0, 1, 1, 0, -0.0, 1, 0.5], np.float32)
    for sign in (1, -1):
        want_v, want_i = jax.lax.top_k(jnp.asarray(sign * x), 5)
        got_v, got_i = tflat_core._top_k(t(sign * x), 5)
        np.testing.assert_array_equal(n(got_i), n(want_i))
        np.testing.assert_array_equal(n(got_v).view(np.uint32), n(want_v).view(np.uint32))
    rng = np.random.default_rng(9)
    xs = rng.choice(np.array([0.0, -0.0, 2.0, -2.0, 3.0, np.inf, -np.inf], np.float32),
                    size=(4, 300))
    for k in (1, 17, 300):
        np.testing.assert_array_equal(n(tflat_core._top_k(t(xs), k)[1]),
                                      n(jax.lax.top_k(jnp.asarray(xs), k)[1]))


def test_exchange_local_over_several_clients_raises():
    """More clients than the space's group has ranks (here: one)."""
    _, tspace = spaces(SPARSE)
    tspace.n_clients = 2
    with pytest.raises(ValueError, match="needs a ClientGroup of 2 ranks"):
        tspace.exchange_local([t(b) for b in bodies_for(SPARSE, 0)], None)


# ------------------------------------------------------------ the slice


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def warm_state(jfns, seed=42):
    """The reference's initial state with a warm Adam state from a seed,
    as numpy."""
    jstate = jfns.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    jstate["opt"] = JAdamState(
        jax.tree.map(lambda m: jnp.asarray(0.01 * rng.standard_normal(m.shape),
                                           jnp.float32), jstate["opt"].m),
        jax.tree.map(lambda v: jnp.asarray((0.01 * rng.standard_normal(v.shape)) ** 2,
                                           jnp.float32), jstate["opt"].v),
    )
    return jax.tree.map(np.asarray, jstate)


@pytest.mark.parametrize("device_pack", [False, True], ids=["host-metered", "device-pack"])
def test_three_exact_rounds_match_jax(device_pack):
    jcfg = dataclasses.replace(j_get_config("lenet5"), img_size=12)
    jfns = j_build_dist_train(jcfg, one_device_mesh(), compressor="sbc", sparsity=0.01,
                              fast=True, flat_engine="exact", measure=True,
                              device_pack=device_pack)
    tfns = build_dist_train(dataclasses.replace(get_config("lenet5"), img_size=12),
                            sparsity=0.01, fast=True, flat_engine="exact", measure=True,
                            device_pack=device_pack, device="cpu")
    np_state = warm_state(jfns)
    jstate = jax.tree.map(jnp.asarray, np_state)
    tstate = state_from_jax(np_state, device="cpu")
    rng = np.random.default_rng(0)
    differing_rounds = 0
    for r in range(3):
        b = {"images": rng.standard_normal((1, 16, 12, 12, 1)).astype(np.float32),
             "labels": rng.integers(0, 10, (1, 16)).astype(np.int32)}
        jstate, jm = jfns.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tfns.train_step(tstate, {"images": t(b["images"]),
                                              "labels": t(b["labels"]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if r == 0 else 1e-4, err_msg=f"round {r + 1}")
        same = all(np.array_equal(n(tm["own_client0"][k]) != 0, n(v) != 0)
                   for k, v in jm["own_client0"].items())
        differing_rounds += not same
        if device_pack and same:
            np.testing.assert_array_equal(n(tm["packed_words_client0"]),
                                          n(jm["packed_words_client0"]))
            np.testing.assert_array_equal(n(tm["packed_nbits"]), n(jm["packed_nbits"]))
        jfns.channel.record_round(r, own_client0=jm.get("own_client0"),
                                  packed_nbits=jm.get("packed_nbits"))
        tfns.channel.record_round(r, own_client0=tm.get("own_client0"),
                                  packed_nbits=tm.get("packed_nbits"))
    assert differing_rounds == 0
    assert tfns.channel.ledger.totals() == jfns.channel.ledger.totals()
    assert tfns.channel.ledger.history() == jfns.channel.ledger.history()
    tfns.channel.ledger.reconcile(rel=0.25)
    for k, v in tstate["params"].items():
        np.testing.assert_allclose(n(v), n(jstate["params"][k]), rtol=1e-4, atol=1e-6)
