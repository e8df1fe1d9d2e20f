"""``repro_torch.kernels.reduce.f32_mean_xla`` against ``jnp.mean`` and
``jnp.sum`` on XLA's CPU backend, bit for bit.

The reference puts ``jnp.mean`` of f32 top-k values on the wire (SBC's
μ), so the port reproduces XLA's reduce order: a cascade of size-32,
stride-32 windows with the pad split front and back, then × ``1.0f / n``.
These tests catch a JAX upgrade that changes that lowering: eager calls,
rows under ``jax.jit`` (the exact engines) and ``jax.vmap``, and the sums
(``two_means``, ``stochastic``'s norm).  On the CPU the wrapper runs its
plain PyTorch version; ``test_torch_cuda.py`` holds the CUDA kernel
against it on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.kernels.reduce import f32_mean_xla, f32_mean_xla_plain
from torch_helpers import n, t

SIZES = (1, 5, 13, 32, 33, 50, 250, 1_000, 12_250, 12_561, 100_000)


def draw(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))).astype(np.float32)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("size", SIZES)
def test_mean_and_sum_match_jnp_bit_for_bit(size):
    for seed in range(5):
        x = draw(size, seed)
        np.testing.assert_array_equal(bits(n(f32_mean_xla(t(x)))), bits(jnp.mean(x)))
        np.testing.assert_array_equal(bits(n(f32_mean_xla(t(x), sum_only=True))),
                                      bits(jnp.sum(x)))


@pytest.mark.parametrize("size", (5, 250, 12_250))
def test_rows_under_jit_and_vmap(size):
    x = draw((6, size), 11)
    want_jit = jax.jit(lambda v: jnp.mean(v, axis=-1))(x)
    want_vmap = jax.jit(jax.vmap(jnp.mean))(x)
    got = n(f32_mean_xla(t(x)))
    np.testing.assert_array_equal(bits(got), bits(want_jit))
    np.testing.assert_array_equal(bits(got), bits(want_vmap))
    # the stacked [2·rows, k] form of the two-sided top-k: both sides at once
    both = np.concatenate([x, -x])
    np.testing.assert_array_equal(bits(n(f32_mean_xla(t(both)))),
                                  bits(jax.vmap(jnp.mean)(both)))


def test_rows_inside_scan_as_the_exact_engine_runs_them():
    x = draw((4, 25_000), 3)

    def body(_, row):
        vals, _ = jax.lax.top_k(row, 250)
        return None, jnp.mean(vals)

    _, want = jax.jit(lambda v: jax.lax.scan(body, None, v))(x)
    vals = np.asarray(jax.vmap(lambda r: jax.lax.top_k(r, 250)[0])(x))
    np.testing.assert_array_equal(bits(n(f32_mean_xla(t(vals)))), bits(want))


@pytest.mark.parametrize("size", (3, 40, 1_000))
def test_signed_zeros_and_ties(size):
    """An all −0 row sums to +0 (every window starts from +0.0), as XLA's
    reduce does; the mean of equal values is that value × n × (1/n)."""
    z = np.full(size, -0.0, np.float32)
    np.testing.assert_array_equal(bits(n(f32_mean_xla(t(z), sum_only=True))),
                                  bits(jnp.sum(z)))
    c = np.full(size, 0.1, np.float32)
    np.testing.assert_array_equal(bits(n(f32_mean_xla(t(c)))), bits(jnp.mean(c)))


def test_plain_is_the_cpu_route_and_keeps_shape():
    x = draw((2, 3, 70), 5)
    got = f32_mean_xla(t(x))
    assert tuple(got.shape) == (2, 3)
    np.testing.assert_array_equal(bits(n(got)), bits(n(f32_mean_xla_plain(t(x)))))
    np.testing.assert_array_equal(bits(n(got)), bits(jnp.mean(x, axis=-1)))


def test_rejects_what_it_does_not_take():
    with pytest.raises(TypeError):
        f32_mean_xla(t(np.zeros(4, np.float64)))
    with pytest.raises(ValueError):
        f32_mean_xla(t(np.zeros((3, 0), np.float32)))
