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
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

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


@pytest.mark.parametrize("shape", [(3, 5, 96), (7, 32 * 3), (1, 32 * 128), (2, 32 * 129)])
@pytest.mark.parametrize("values", ["bits", "full-words"])
def test_pack_bit_rows_ragged_and_full_words_match_jax(shape, values):
    """Ragged lengths (not a multiple of 32 · 128 bits, where the
    reference pads) and any u32 value (bits shifted past bit 31 are lost
    in both)."""
    rng = np.random.default_rng(3)
    if values == "bits":
        bits = rng.integers(0, 2, shape).astype(np.uint32)
    else:
        bits = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    want = n(jpack.pack_bit_rows(jnp.asarray(bits), interpret=True))
    got = tpack.pack_bit_rows(t(bits.view(np.int32)))
    assert tuple(got.shape) == shape[:-1] + (shape[-1] // 32,)
    np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("nbits", [1, 31, 32, 33, 1000, 32 * 130 + 7])
def test_seg_packbits_stream_plain_is_np_packbits(nbits):
    """Any length: the ragged last word is zero-filled."""
    bits = np.random.default_rng(nbits).integers(0, 2, nbits).astype(np.int32)
    got = n(tpack.seg_packbits_stream(t(bits)))
    assert got.shape == (-(-nbits // 32),)
    want = np.packbits(np.concatenate([bits, np.zeros(-nbits % 32, np.int32)]).astype(np.uint8))
    assert got.astype(">u4").tobytes() == want.tobytes()


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


# ------------------------------------- the CUDA seg_select_pack's tile scan
#
# A plain model of how csrc/pack.cu splits a row over tiles of T slots:
# each tile's state (count, first, last, Σq after its first), the
# associative combine, a look-back over predecessors some of which have
# published only their aggregate, then each tile's contiguous range of
# stream bits (whole words stored, the two partial end words kept as
# pieces) and the last CTA's assembly.  At small T it puts the carry
# algebra on the CPU: codewords split across tiles, unary runs across
# empty tiles, the k cut and the −1 rule.

_GARBAGE = 0xDEADBEEF  # what torch.empty may hold: every word must be written


def _tile_state(sel, b):
    """(c, f, l, sq) of the sorted selected positions of one tile."""
    if sel.size == 0:
        return (0, -1, -1, 0)
    sq = int(sum((int(q) - int(p) - 1) >> b for p, q in zip(sel[:-1], sel[1:])))
    return (int(sel.size), int(sel[0]), int(sel[-1]), sq)


def _combine(a, c, b):
    if a[0] == 0:
        return c
    if c[0] == 0:
        return a
    return (a[0] + c[0], a[1], c[2], a[3] + c[3] + ((c[1] - a[2] - 1) >> b))


def _look_back(states, published, j, b, lanes=32):
    """Exclusive prefix of tile j: windows of ``lanes`` predecessors, each
    folded in tile order up to the nearest inclusive prefix."""
    excl = (0, -1, -1, 0)
    base = j - 1
    while True:
        window, done = (0, -1, -1, 0), False
        for jj in range(base, base - lanes, -1):  # nearest first
            if jj < 0:
                done = True
                break
            if published[jj] == 2:
                window = _combine(states["incl"][jj], window, b)
                done = True
                break
            window = _combine(states["agg"][jj], window, b)
        excl = _combine(window, excl, b)
        if done:
            return excl
        base -= lanes


def _or_bits(buf, cap, pos, val, nb):
    """OR the nb-bit value (most significant first) into stream bits
    [pos, pos + nb) of the word buffer, dropping bits at or past cap."""
    for i in range(nb):
        bit = pos + i
        if bit < cap and (val >> (nb - 1 - i)) & 1:
            buf[bit >> 5] |= np.uint32(1 << (31 - (bit & 31)))


def _model_select_pack(masks, k, b, T, rng):
    rows, n_slots = masks.shape
    W = jpack.row_words(n_slots, k, b)
    cap, cl = 32 * W, 1 + b
    tpr = -(-n_slots // T)
    out = np.full((rows, W), _GARBAGE, np.uint32)
    stored = np.zeros((rows, W), np.int64)  # whole-word stores per word
    nbits = np.full((rows,), -7, np.int64)  # -7: not written
    pieces, incl_last = [], []
    for r in range(rows):
        aggs = [_tile_state(np.flatnonzero(masks[r, j * T:(j + 1) * T]) + j * T, b)
                for j in range(tpr)]
        states = {"agg": aggs, "incl": [None] * tpr}
        published = np.zeros(tpr, np.int64)
        # tiles finish in an order of their own: a predecessor may show
        # only its aggregate, or already its inclusive prefix
        for j in range(tpr):
            prefix = (0, -1, -1, 0) if j == 0 else _look_back(states, published, j, b)
            states["incl"][j] = _combine(prefix, aggs[j], b)
            published[j] = 2 if j == 0 or rng.uniform() < 0.5 else 1
            c, f, _, sq = aggs[j]
            r0 = prefix[0]
            if c == 0 or r0 >= k:
                continue
            emitted = min(c, k - r0)
            prev_pos = prefix[2] if r0 else -1
            q_first = (f - prev_pos - 1) >> b
            s = ((prefix[1] >> b) + prefix[3] if r0 else 0) + r0 * cl
            s2 = s + q_first
            sw = s2 >> 5
            buf = np.zeros(((T * cl + (T >> b) + 63) // 32 + 1,), np.uint32)
            bcap = cap - 32 * sw
            start_ones = max(s, 32 * sw)
            _or_bits(buf, bcap, start_ones - 32 * sw, (1 << (s2 - start_ones)) - 1,
                     s2 - start_ones)
            sel = np.flatnonzero(masks[r, j * T:(j + 1) * T]) + j * T
            p_prev, qacc, e = prev_pos, 0, None
            for i, p in enumerate(sel[:emitted]):
                dm1 = int(p) - p_prev - 1
                q = dm1 >> b
                start = s + qacc + i * cl
                if i > 0:
                    _or_bits(buf, bcap, start - 32 * sw, (1 << q) - 1, q)
                if b:
                    _or_bits(buf, bcap, start + q + 1 - 32 * sw, dm1 & ((1 << b) - 1), b)
                e = start + q + cl
                if r0 + i == k - 1:
                    nbits[r] = e
                qacc += q
                p_prev = int(p)
            w_lo, w_hi = s >> 5, (e - 1) >> 5
            for w in range(w_lo, min(w_hi, W - 1) + 1):
                val = np.uint32(0xFFFFFFFF >> max(s - 32 * w, 0)) if w < sw else buf[w - sw]
                if (w == w_lo and s & 31) or (w == w_hi and e & 31):
                    pieces.append((r, w, val))
                else:
                    out[r, w] = val
                    stored[r, w] += 1
        incl_last.append(states["incl"][-1] if tpr else (0, -1, -1, 0))
    # the last CTA
    for r in range(rows):
        end = 0
        if k > 0:
            c, f, _, sq = incl_last[r]
            if c >= k:
                end = int(nbits[r])
            else:
                end = (f >> b) + sq + c * cl if c else 0
                nbits[r] = -1
        else:
            nbits[r] = 0
        out[r, -(-end // 32):] = 0
    for r, w, _ in pieces:
        out[r, w] = 0
    for r, w, val in pieces:
        out[r, w] |= val
    assert stored.max(initial=0) <= 1, "a word stored by two tiles"
    return out, nbits


def _tile_cases():
    """``(id, T, p, masks int32[rows, n], k)``."""
    rng = np.random.default_rng(30)
    cases = []
    for T in (32, 64):
        for p in (0.01, 0.05, 0.5):  # b* = 6, 4, 0
            n_slots = 12 * T
            m = np.zeros((3, n_slots), np.int32)
            m[0, [1, 3 * T + 5, 3 * T + 6, 7 * T + 1, 12 * T - 1]] = 1  # runs over empty tiles
            m[1, [T - 1, T, 2 * T - 1, 2 * T, 5 * T]] = 1  # each side of tile edges
            m[2, rng.choice(n_slots, 5, replace=False)] = 1
            cases.append((f"multi-tile-T{T}-p{p}", T, p, m, 5))
            dense = (rng.uniform(size=(2, n_slots)) < 0.3).astype(np.int32)
            k = int(dense.sum(1).min())
            cases.append((f"dense-T{T}-p{p}", T, p, dense, k))
        cases.append((f"k-eq-n-T{T}", T, 0.5, np.ones((2, 5 * T), np.int32), 5 * T))
        last = np.zeros((1, 3 * T), np.int32)
        last[0, -1] = 1
        cases.append((f"k1-last-slot-T{T}", T, 0.01, last, 1))
        # more than k set slots: the first k are packed
        over = (rng.uniform(size=(3, 9 * T)) < 0.2).astype(np.int32)
        cases.append((f"over-k-T{T}", T, 0.05, over, int(over.sum(1).min()) // 2))
        cases.append((f"ragged-n-T{T}", T, 0.05,
                      (rng.uniform(size=(2, 4 * T + 7)) < 0.1).astype(np.int32), 3))
    return cases


TILE_CASES = _tile_cases()


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_tile_scan_model_matches_bits_from_mask(case):
    _, T, p, masks, k = case
    b = jgolomb.golomb_bstar(p)
    assert (masks.sum(1) >= k).all()
    got_w, got_nb = _model_select_pack(masks, k, b, T, np.random.default_rng(31))
    want_w, want_nb = tpack.seg_select_pack_plain(t(masks), k=k, bstar=b)
    np.testing.assert_array_equal(got_w, n(want_w))
    np.testing.assert_array_equal(got_nb, n(want_nb))
    jw, jnb = jpack.seg_select_pack(jnp.asarray(masks), k=k, bstar=b, interpret=True)
    np.testing.assert_array_equal(got_w, n(jw))
    np.testing.assert_array_equal(got_nb, n(jnb))
    for r in range(masks.shape[0]):
        host, host_nb = tgolomb.encode_positions_packed(np.flatnonzero(masks[r])[:k], p)
        assert got_nb[r] == host_nb
        assert tgolomb.packed_words_to_bytes(got_w[r], host_nb) == host


@pytest.mark.parametrize("T", [32, 64])
def test_tile_scan_model_short_rows_and_k_zero(T):
    """Fewer than k set slots: nbits −1, and the words are the stream of
    the slots there are, zero past it (every word written, no memset).
    k = 0: nbits 0 and no words."""
    rng = np.random.default_rng(32)
    masks = (rng.uniform(size=(3, 7 * T)) < 0.05).astype(np.int32)
    masks[1] = 0
    masks[2, :] = 0
    masks[2, 6 * T + 3] = 1
    b = 4
    k = int(masks.sum(1).max()) + 1
    words, nbits = _model_select_pack(masks, k, b, T, rng)
    assert nbits.tolist() == [-1, -1, -1]
    assert (words != _GARBAGE).all()
    W = jpack.row_words(7 * T, k, b)
    for r in range(3):
        c = int(masks[r].sum())
        want, _ = tpack.seg_select_pack_plain(t(masks[r:r + 1]), k=c, bstar=b)
        row = np.zeros((W,), np.uint32)
        row[:want.shape[1]] = n(want)[0]
        np.testing.assert_array_equal(words[r], row)
    words0, nbits0 = _model_select_pack(masks, 0, b, T, rng)
    assert words0.shape == (3, 0) and nbits0.tolist() == [0, 0, 0]
