"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; only launch/dryrun.py fakes 512 devices (in its own process).

The suite is XLA-compile dominated, so two layers of caching keep wall time
down (ISSUE 2 satellite):

  * a persistent on-disk XLA compilation cache (``tests/.jax_cache``,
    gitignored) — repeat local runs skip almost every compile;
  * session-scoped model/param builders (``arch_setup``, ``lm_setup``) —
    each reduced architecture is built and initialized ONCE and shared by
    every test that exercises it, so ``model.init``/``loss_fn`` jit caches
    hit across tests instead of recompiling per test function.
"""
import functools
import os

import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import ModelConfig

try:  # persistent compile cache: first run pays, reruns are fast
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
except Exception:  # older jax without the flags — caching is best-effort
    pass


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def tiny_decoder(**kw) -> ModelConfig:
    base = dict(
        name="tiny", family="decoder", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=97, dtype=jnp.float32,
    )
    base.update(kw)
    return ModelConfig(**base)


@functools.lru_cache(maxsize=None)
def arch_setup(arch: str):
    """(cfg, model, params) for one REDUCED architecture, built once per
    session.  Sharing the *same* model object across tests lets later
    ``model.init`` / ``loss_fn`` calls hit the jit cache instead of
    recompiling (params are immutable jax arrays, safe to share)."""
    from repro.configs.base import get_config, reduced
    from repro.models.model import build_model

    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


@functools.lru_cache(maxsize=None)
def tiny_lm_setup():
    """(cfg, model, task) for the tiny decoder LM shared by the trainer and
    codec-pipeline integration tests (identical config → one compile set)."""
    from repro.data import make_lm_task
    from repro.models.model import build_model

    cfg = tiny_decoder()
    model = build_model(cfg)
    task = make_lm_task(vocab=cfg.vocab_size, batch=8, seq_len=32,
                        temperature=0.3)
    return cfg, model, task


@pytest.fixture(scope="session")
def lm_setup():
    return tiny_lm_setup()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
