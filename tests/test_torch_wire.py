"""The port's SBW1 wire (``repro_torch.core.wire``) and analytic bits
(``repro_torch.core.bits``) against the JAX package's, on the CPU.

Every comparison is exact:
  * two-way SBW1: the same update compressed by both packages packs to
    the same bytes; a blob packed by either package unpacks in the other
    and re-packs to the same bytes, with the same dense reconstruction
    and measured bits.  The stochastic codecs' leaves are drawn by the
    reference and handed across (torch cannot draw threefry bits);
  * the corruptions of ``tests/test_wire_fuzz.py`` raise ``ValueError`` in
    the port too (a prefix or a flipped byte either parses or raises
    ``ValueError``, nothing else);
  * ``device_pack=True`` on the CPU (the plain ``seg_select_pack``) gives
    the host pack's bytes and bits (the oracle of
    ``tests/test_channel_parity.py``'s device-pack test);
  * ``bits.py``: Table I rows and the Eq. 1 helpers equal.
"""
import random
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core import bits as jbits
from repro.core import policy as jpol
from repro.core import wire as jwire
from repro.core.codec import make_codec as j_make_codec
from repro_torch.core import bits as tbits
from repro_torch.core import policy as tpol
from repro_torch.core import wire as twire
from repro_torch.core.codec import make_codec as t_make_codec
from repro_torch.core.stages import LeafCompressed
from repro_torch.kernels import pack as tpack
from torch_helpers import n, t


def tree(seed=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal(4096)).astype(np.float32),
            "v": (scale * rng.standard_normal((64, 8))).astype(np.float32),
            "bias": (scale * rng.standard_normal(16)).astype(np.float32),
            "skipme": (scale * rng.standard_normal(32)).astype(np.float32)}


def policy(pkg, name):
    make, pol = (j_make_codec, jpol) if pkg == "jax" else (t_make_codec, tpol)
    single = {"sbc": "sbc", "dense32": "dense32", "skip": "skip",
              "topk-raw16": "topk|identity|raw16", "signsgd": "dense|sign|none",
              "onebit": "dense|two_means|none", "sparse-sign": "topk|sign|raw32",
              "bitmask": "topk_signed|identity|bitmask", "variance": "variance|identity|golomb"}
    if name in single:
        return pol.CompressionPolicy.single(make(single[name]))
    rules = {
        "fed-dense-small": (pol.PolicyRule(pol.DENSE_SMALL_PATTERN, codec="dense32"),),
        "gspmd-mixed": (pol.PolicyRule(r"bias", codec="dense32"),
                        pol.PolicyRule(r"skipme", codec="skip")),
        "mixed-codecs": (pol.PolicyRule(r"^v$", codec="topk|identity|raw16"),
                         pol.PolicyRule(r"bias", codec="dense|sign|none"),
                         pol.PolicyRule(r"skipme", codec="topk|binarize|raw32")),
    }[name]
    return pol.CompressionPolicy(default=make("sbc"), rules=rules)


DETERMINISTIC = ["sbc", "dense32", "skip", "topk-raw16", "signsgd", "onebit", "sparse-sign",
                 "bitmask", "variance", "fed-dense-small", "gspmd-mixed", "mixed-codecs"]


def compress_both(name, p=0.02, seed=3):
    delta = tree(seed)
    jr = policy("jax", name).resolve({k: jnp.asarray(v) for k, v in delta.items()})
    tr = policy("torch", name).resolve({k: t(v) for k, v in delta.items()})
    jd = {k: jnp.asarray(v) for k, v in delta.items()}
    td = {k: t(v) for k, v in delta.items()}
    jc, jdense, _ = jr.compress(jd, jr.init_state(jd), jr.rates(p))
    tc, tdense, _ = tr.compress(td, tr.init_state(td), tr.rates(p))
    return (jwire.wire_for(jr, jd, p), jc, jdense), (twire.wire_for(tr, td, p), tc, tdense)


def assert_dense_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(n(a[k]), np.float32).view(np.uint32),
                                      np.asarray(n(b[k]), np.float32).view(np.uint32), k)


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_two_way_sbw1(name):
    (jw, jc, jdense), (tw, tc, tdense) = compress_both(name)
    assert tw.specs == tuple(twire.LeafSpec(*s) for s in jw.specs)
    jblob, jbits_ = jw.pack_with_bits(jc)
    tblob, tbits_ = tw.pack_with_bits(tc)
    assert tblob == jblob and tbits_ == jbits_
    assert tw.measured_bits(tc) == jw.measured_bits(jc)
    assert tw.packed_bytes(tc) == jw.packed_bytes(jc) == len(jblob)
    # the reference's blob in the port: unpack, re-pack, same bytes
    t_comps = tw.unpack_compressed(jblob)
    assert isinstance(t_comps["w"].idx, torch.Tensor)
    assert tw.pack(t_comps) == jblob
    assert_dense_equal(tw.unpack(jblob), jw.unpack(jblob))
    assert_dense_equal(tw.unpack(jblob), tdense)
    # the port's blob in the reference
    assert jw.pack(jw.unpack_compressed(tblob)) == tblob
    assert_dense_equal(jw.unpack(tblob), tw.unpack(tblob))


@pytest.mark.parametrize("spec", ["dense|ternary|none", "dense|stochastic|none",
                                  "randomk|identity|seed", "randomk|sign|raw16",
                                  "randomk|identity|raw32"])
def test_reference_drawn_stochastic_leaves_cross(spec):
    """The stochastic codecs' wire forms: the reference draws, the port
    packs the same leaves to the same bytes and reads the reference's
    bytes back."""
    delta = tree(5)
    jd = {k: jnp.asarray(v) for k, v in delta.items()}
    jr = jpol.CompressionPolicy.single(j_make_codec(spec)).resolve(jd)
    tr = tpol.CompressionPolicy.single(t_make_codec(spec)).resolve({k: t(v) for k, v in
                                                                   delta.items()})
    jc, _, _ = jr.compress(jd, jr.init_state(jd, jax.random.PRNGKey(7)), jr.rates(0.05))
    jw, tw = jwire.wire_for(jr, jd, 0.05), twire.wire_for(tr, {k: t(v) for k, v in
                                                             delta.items()}, 0.05)
    blob = jw.pack(jc)
    handed = {k: LeafCompressed(*(torch.from_numpy(np.array(f)) for f in c))
              for k, c in jc.items()}
    assert tw.pack(handed) == blob
    assert tw.pack(tw.unpack_compressed(blob)) == blob
    assert_dense_equal(tw.unpack(blob), jw.unpack(blob))


# ----------------------------------------------------------- the fuzzing

FUZZ = {"sbc": "sbc", "topk": "topk|identity|raw16", "signsgd": "dense|sign|none",
        "terngrad": "dense|ternary|none", "qsgd": "dense|stochastic|none",
        "none": "dense|identity|none"}


def fuzz_blob(name):
    """The reference's blob of ``tests/test_wire_fuzz.py`` and the port's
    Wire for it."""
    p = 0.01 if name in ("sbc", "topk") else 1.0
    rng = np.random.default_rng(0)
    delta = {"w": (0.01 * rng.standard_normal(3000)).astype(np.float32),
             "b": rng.standard_normal(61).astype(np.float32)}
    jd = {k: jnp.asarray(v) for k, v in delta.items()}
    td = {k: t(v) for k, v in delta.items()}
    jr = jpol.CompressionPolicy.single(j_make_codec(FUZZ[name])).resolve(jd)
    tr = tpol.CompressionPolicy.single(t_make_codec(FUZZ[name])).resolve(td)
    jc, _, _ = jr.compress(jd, jr.init_state(jd), jr.rates(p))
    return twire.wire_for(tr, td, p), jwire.wire_for(jr, jd, p).pack(jc)


@pytest.mark.parametrize("name", sorted(FUZZ))
def test_truncation_and_corruption_raise_value_error(name):
    wire, blob = fuzz_blob(name)
    wire.unpack(blob)
    step = max(1, len(blob) // 60)
    for cut in list(range(0, len(blob), step)) + [len(blob) - 1]:
        try:
            wire.unpack(blob[:cut])
        except ValueError:
            pass
    rng = random.Random(1234)
    for _ in range(200):
        b = bytearray(blob)
        for _ in range(rng.randint(1, 8)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        try:
            wire.unpack(bytes(b))
        except ValueError:
            pass


def test_bad_header_bitcount_and_positions_raise_value_error():
    wire, blob = fuzz_blob("sbc")
    with pytest.raises(ValueError, match="magic"):
        wire.unpack(b"XXXX" + blob[4:])
    with pytest.raises(ValueError, match="leaves"):
        wire.unpack(twire.MAGIC + struct.pack("<I", 99) + blob[8:])
    with pytest.raises(ValueError, match="truncated"):
        wire.unpack(blob[:6])
    b = bytearray(blob)
    struct.pack_into("<I", b, 12, 1 << 31)  # a golomb bit count of 2 Gbit
    with pytest.raises(ValueError):
        wire.unpack(bytes(b))
    wire, blob = fuzz_blob("topk")
    b = bytearray(blob)
    struct.pack_into("<H", b, 12, 0xFFFF)  # a raw16 position past n
    with pytest.raises(ValueError, match="outside"):
        wire.unpack(bytes(b))


# ------------------------------------------------------- the device pack


@pytest.mark.parametrize("name", ["sbc", "fed-dense-small", "gspmd-mixed", "variance",
                                  "mixed-codecs"])
def test_device_pack_on_the_cpu_equals_the_host_pack(name):
    (jw, jc, _), (tw, tc, _) = compress_both(name)
    host_blob, host_bits = tw.pack_with_bits(tc)
    before = tpack.seg_select_pack.launches
    dev_blob, dev_bits = tw.pack_with_bits(tc, device_pack=True)
    assert tpack.seg_select_pack.launches == before  # the CPU runs the plain version
    assert (dev_blob, dev_bits) == (host_blob, host_bits)
    assert tw.pack_device(tc) == host_blob == jw.pack_device(jc, interpret=True)


# ------------------------------------------------------------------ bits


def test_bits_match_jax():
    assert tbits.paper_table1() == [tbits.MethodBits(*dataclass_fields(r))
                                    for r in jbits.paper_table1()]
    for jr, tr in zip(jbits.paper_table1(), tbits.paper_table1()):
        for n_params in (1_256_010, 3_000):
            assert tr.bits_per_iteration(n_params) == jr.bits_per_iteration(n_params)
            assert tr.compression_rate(n_params) == jr.compression_rate(n_params)
    for args in ((1_256_010, 0.01), (500, 0.001), (10, 0.5)):
        assert tbits.sbc_bits_per_round(*args) == jbits.sbc_bits_per_round(*args)
    kw = dict(n_params=1_256_010, n_iterations=1000, delay=10, bits_per_comm=1e5)
    assert tbits.total_upload_bits(**kw) == jbits.total_upload_bits(**kw)
    assert tbits.table1_row("x", golomb=True, sparsity=0.01) == tbits.MethodBits(
        *dataclass_fields(jbits.table1_row("x", golomb=True, sparsity=0.01)))


def dataclass_fields(row):
    return (row.name, row.temporal_sparsity, row.gradient_sparsity, row.value_bits,
            row.position_bits)
