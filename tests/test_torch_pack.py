"""The port's wire packers (repro_torch.kernels.pack) and Golomb coder
(repro_torch.core.golomb) against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
package's Pallas kernels run in interpret mode, as its own
``tests/test_pack_kernels.py`` runs them.  ``test_torch_cuda.py`` holds
the hand-written CUDA kernels against the plain versions on the card.

Everything here is integer bit work, so every comparison is exact: bits,
words, bit counts, decoded positions and bytes.  Words are compared as
numpy ``uint32``.  The rows are adversarial: one survivor at either edge,
every slot selected (k = n), gaps at exact multiples of 2^b*, gaps whose
remainder is all ones, b* = 0, codewords across word boundaries, and
seeded random rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import golomb as jgolomb
from repro.kernels import pack as jpack
from repro_torch.core import golomb as tgolomb
from repro_torch.kernels import pack as tpack
from torch_helpers import n, t

P_GRID = (0.01, 0.05, 0.5)  # b* = 6, 4, 0


def _rows():
    """``(id, n, p, sorted positions)`` per adversarial row."""
    rng = np.random.default_rng(0)
    cases = []
    for p in P_GRID:
        b = jgolomb.golomb_bstar(p)
        step = 1 << b
        cases += [
            (f"first-p{p}", 64, p, [0]),
            (f"last-p{p}", 200, p, [199]),
            (f"all-p{p}", 40, p, list(range(40))),
            # gap − 1 = 2·2^b: q = 2, remainder 0
            (f"gap-multiple-p{p}", 200, p, list(range(2 * step, 200, 2 * step + 1))),
            # gap = 2^b: q = 0, remainder all ones
            (f"gap-pow2-p{p}", 200, p, list(range(step - 1, 200, step))),
            (f"random-p{p}", 200, p, sorted(rng.choice(200, 23, replace=False).tolist())),
        ]
    cases.append(("one-slot", 1, 0.01, [0]))
    return cases


ROWS = _rows()
IDS = [c[0] for c in ROWS]


def _cap32(n_slots, k, b):
    return 32 * jpack.row_words(n_slots, k, b)


def _mask(n_slots, pos):
    m = np.zeros((n_slots,), np.int32)
    m[np.asarray(pos, np.int64)] = 1
    return m


def test_row_capacity_matches_reference():
    for n_slots in (1, 7, 64, 200, 1_225_000):
        for k in (0, 1, n_slots // 100, n_slots):
            for b in (0, 1, 4, 6, 12):
                assert tpack.row_bit_capacity(n_slots, k, b) == jpack.row_bit_capacity(n_slots, k, b)
                assert tpack.row_words(n_slots, k, b) == jpack.row_words(n_slots, k, b)


@pytest.mark.parametrize("case", ROWS, ids=IDS)
def test_bits_from_positions_and_mask_match_jax(case):
    _, n_slots, p, pos = case
    b, k = jgolomb.golomb_bstar(p), len(pos)
    cap = _cap32(n_slots, k, b)
    want_bits, want_nb = jpack.bits_from_positions(jnp.asarray(pos, jnp.int32), bstar=b, cap32=cap)
    got_bits, got_nb = tpack.bits_from_positions(t(np.asarray(pos, np.int32)), bstar=b, cap32=cap)
    np.testing.assert_array_equal(n(got_bits), n(want_bits).astype(np.int32))
    assert int(got_nb) == int(want_nb)
    m = _mask(n_slots, pos)
    want_mbits, want_mnb = jpack.bits_from_mask(jnp.asarray(m), k=k, bstar=b, cap32=cap)
    got_mbits, got_mnb = tpack.bits_from_mask(t(m), k=k, bstar=b, cap32=cap)
    np.testing.assert_array_equal(n(got_mbits), n(want_mbits).astype(np.int32))
    assert int(got_mnb) == int(want_mnb) == int(want_nb)
    # and the bits are the host encoder's stream, zero-padded
    host = tgolomb.encode_positions(np.asarray(pos), p)
    np.testing.assert_array_equal(n(got_bits)[:host.size], host)
    assert not n(got_bits)[host.size:].any()


def test_bits_from_positions_batches_rows():
    """A leading row axis encodes each row on its own (the reference vmaps)."""
    rng = np.random.default_rng(1)
    pos = np.sort(np.stack([rng.choice(300, 9, replace=False) for _ in range(4)]), 1)
    cap = _cap32(300, 9, 4)
    bits, nb = tpack.bits_from_positions(t(pos.astype(np.int32)), bstar=4, cap32=cap)
    for r in range(4):
        wb, wn = jpack.bits_from_positions(jnp.asarray(pos[r], jnp.int32), bstar=4, cap32=cap)
        np.testing.assert_array_equal(n(bits[r]), n(wb).astype(np.int32))
        assert int(nb[r]) == int(wn)


@pytest.mark.parametrize("planes", ["bits", "full-words"])
def test_seg_packbits_plain_matches_jax(planes):
    rng = np.random.default_rng(2)
    if planes == "bits":
        x = rng.integers(0, 2, (32, 256)).astype(np.uint32)
    else:  # any u32 value: bits shifted past bit 31 are lost in both
        x = rng.integers(0, 2 ** 32, (32, 256), dtype=np.uint64).astype(np.uint32)
    want = n(jpack.seg_packbits(jnp.asarray(x), interpret=True))
    got = tpack.seg_packbits(t(x.view(np.int32)))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(n(got), want)
    got_u = tpack.seg_packbits(t(x.view(np.int32)).view(torch.uint32))
    np.testing.assert_array_equal(n(got_u), want)


def test_pack_bit_rows_matches_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, 5, 96)).astype(np.uint32)
    want = n(jpack.pack_bit_rows(jnp.asarray(bits), interpret=True))
    got = tpack.pack_bit_rows(t(bits.view(np.int32)))
    assert tuple(got.shape) == (3, 5, 3)
    np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("case", ROWS, ids=IDS)
def test_seg_select_pack_plain_matches_jax_and_the_host_bytes(case):
    _, n_slots, p, pos = case
    b, k = jgolomb.golomb_bstar(p), len(pos)
    m = _mask(n_slots, pos)[None]
    want_w, want_nb = jpack.seg_select_pack(jnp.asarray(m), k=k, bstar=b, interpret=True)
    got_w, got_nb = tpack.seg_select_pack(t(m), k=k, bstar=b)
    np.testing.assert_array_equal(n(got_w), n(want_w))
    np.testing.assert_array_equal(n(got_nb), n(want_nb))
    # the bool mask, as the reference accepts it, gives the same words
    got_wb, _ = tpack.seg_select_pack(t(m).bool(), k=k, bstar=b)
    np.testing.assert_array_equal(n(got_wb), n(want_w))
    host, host_nbits = tgolomb.encode_positions_packed(np.asarray(pos), p)
    assert tgolomb.packed_words_to_bytes(n(got_w)[0], int(got_nb[0])) == host
    assert int(got_nb[0]) == host_nbits
    # the staged path (positions → bits → seg_packbits) gives the same words
    bits, _ = tpack.bits_from_positions(t(np.asarray(pos, np.int32)), bstar=b,
                                        cap32=_cap32(n_slots, k, b))
    np.testing.assert_array_equal(n(tpack.pack_bit_rows(bits[None]))[0], n(got_w)[0])


def test_seg_select_pack_empty_rows_and_k_zero():
    words, nbits = tpack.seg_select_pack(torch.zeros((3, 50), dtype=torch.int32), k=0, bstar=6)
    assert tuple(words.shape) == (3, 0) and n(nbits).tolist() == [0, 0, 0]
    # (the reference's Pallas kernel cannot launch on a 0-word block; its
    # stream builder gives the same empty stream)
    jb, jn = jpack.bits_from_mask(jnp.zeros((50,), jnp.int32), k=0, bstar=6, cap32=0)
    assert jb.shape == (0,) and int(jn) == 0


@pytest.mark.parametrize("case", ROWS, ids=IDS)
def test_golomb_decode_rows_matches_jax(case):
    _, n_slots, p, pos = case
    b, k = jgolomb.golomb_bstar(p), len(pos)
    m = _mask(n_slots, pos)[None]
    words, _ = jpack.seg_select_pack(jnp.asarray(m), k=k, bstar=b, interpret=True)
    want = n(jpack.golomb_decode_rows(words, k=k, bstar=b))
    got = tpack.golomb_decode_rows(t(n(words).view(np.int32)).view(torch.uint32), k=k,
                                   bstar=b)
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(got)[0], np.asarray(pos))


def test_golomb_decode_rows_batches_leading_axes():
    """u32[C, rows, W] → int32[C, rows, k], as the exchange decodes a
    gathered cohort; k = 1 and a long row included."""
    rng = np.random.default_rng(4)
    for n_slots, k, p in ((5000, 50, 0.01), (100, 1, 0.05)):
        b = jgolomb.golomb_bstar(p)
        pos = np.sort(np.stack([rng.choice(n_slots, k, replace=False) for _ in range(6)]), 1)
        masks = np.zeros((6, n_slots), np.int32)
        np.put_along_axis(masks, pos, 1, 1)
        words, _ = tpack.seg_select_pack(t(masks), k=k, bstar=b)
        stacked = words.view(torch.int32).reshape(2, 3, -1)
        got = n(tpack.golomb_decode_rows(stacked, k=k, bstar=b)).reshape(6, k)
        np.testing.assert_array_equal(got, pos)
        want = n(jpack.golomb_decode_rows(jnp.asarray(n(words).reshape(2, 3, -1)), k=k, bstar=b))
        np.testing.assert_array_equal(got, want.reshape(6, k))


# ------------------------------------------------------------------- golomb


def test_golomb_matches_reference_byte_for_byte():
    rng = np.random.default_rng(5)
    for p in (0.001, 0.01, 0.05, 0.3, 0.5, 0.9):
        assert tgolomb.golomb_bstar(p) == jgolomb.golomb_bstar(p)
        assert tgolomb.expected_position_bits(p) == jgolomb.expected_position_bits(p)
        for n_slots, k in ((1, 1), (64, 1), (1000, 10), (1000, 1000), (5000, 37)):
            idx = rng.choice(n_slots, k, replace=False)  # unsorted on purpose
            bits = tgolomb.encode_positions(idx, p)
            np.testing.assert_array_equal(bits, jgolomb.encode_positions(idx, p))
            packed = tgolomb.encode_positions_packed(idx, p)
            assert packed == jgolomb.encode_positions_packed(idx, p)
            np.testing.assert_array_equal(tgolomb.decode_positions(bits, p),
                                          jgolomb.decode_positions(bits, p))
            np.testing.assert_array_equal(tgolomb.decode_positions(bits, p), np.sort(idx))
            words = rng.integers(0, 2 ** 32, 9, dtype=np.uint64).astype(np.uint32)
            nb = int(rng.integers(0, 9 * 32 + 1))
            assert (tgolomb.packed_words_to_bytes(words, nb)
                    == jgolomb.packed_words_to_bytes(words, nb))
            msg = tgolomb.encode_sbc_message(idx, 0.25, p)
            ref = jgolomb.encode_sbc_message(idx, 0.25, p)
            assert msg.keys() == ref.keys()
            np.testing.assert_array_equal(msg["positions"], ref["positions"])
            assert tgolomb.message_bits(msg) == jgolomb.message_bits(ref)
            np.testing.assert_array_equal(tgolomb.decode_sbc_message(msg, n_slots),
                                          jgolomb.decode_sbc_message(ref, n_slots))
    assert tgolomb.encode_positions_packed(np.zeros((0,), np.int64), 0.01) == (b"", 0)
    counts = np.array([3, 0, 2, 5])
    np.testing.assert_array_equal(tgolomb._ragged_arange(counts),
                                  jgolomb._ragged_arange(counts))
    with pytest.raises(ValueError, match="truncated Golomb stream"):
        tgolomb.decode_positions(np.array([0, 1], np.uint8), 0.01)


# ---------------------------------------------------------------- wrappers


def test_cpu_wrappers_run_the_plain_versions_and_check_operands():
    tpack.reset_launches()
    planes = torch.zeros((32, 128), dtype=torch.int32)
    assert n(tpack.seg_packbits(planes)).sum() == 0
    tpack.seg_select_pack(torch.ones((2, 10), dtype=torch.int32), k=10, bstar=0)
    assert tpack.launch_counts() == {"seg_packbits": 0, "seg_select_pack": 0}
    with pytest.raises(TypeError):
        tpack.seg_packbits(planes.float())
    with pytest.raises(ValueError):
        tpack.seg_packbits(planes[:31])  # not 32 planes
    with pytest.raises(ValueError):
        tpack.seg_packbits(torch.zeros((32, 100), dtype=torch.int32))  # not whole lanes
    with pytest.raises(ValueError):
        tpack.seg_packbits(torch.zeros((128, 32), dtype=torch.int32).T)  # not contiguous
    with pytest.raises(TypeError):
        tpack.seg_select_pack(torch.ones((2, 10)), k=1, bstar=0)
    with pytest.raises(ValueError):
        tpack.seg_select_pack(torch.ones((10,), dtype=torch.int32), k=1, bstar=0)
    with pytest.raises(ValueError):
        tpack.seg_select_pack(torch.ones((2, 10), dtype=torch.int32), k=11, bstar=0)
