"""Greedy serving of the MoE and recurrent decoders (mixtral-8x7b,
llama4-maverick, jamba-v0.1, rwkv6-1.6b; ROADMAP A12, part 3, items 1
and 2) through ``ServeEngine`` against the JAX package's, on the CPU, at
the reference's ``reduced`` sizes; and jamba's local DSGD round
(``tests/test_torch_zoo_run.py``'s ``one_round``), here so that each of
the two files stays within a minute.

Each reference model is built once for the module (the fixture of
``tests/test_torch_zoo_model.py``); prompts come from numpy seeds.
Tolerances (the decode step against prefill is
``tests/test_torch_zoo_model.py``'s):
  * greedy ``ServeEngine`` tokens: equal, token for token;
  * jamba's round: as ``tests/test_torch_zoo_run.py`` states.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import ServeEngine as JServeEngine
from repro_torch.serve import ServeEngine
from test_torch_zoo_model import BATCH, arch, tokens  # noqa: F401  (the fixture)
from test_torch_zoo_run import one_round
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_greedy_tokens_are_the_references(arch):  # noqa: F811
    name, jm, jp, tm, tp = arch
    tok = tokens(tm.cfg.vocab_size, (BATCH, 12), 4)
    want = np.asarray(JServeEngine(jm).generate(jp, {"tokens": jnp.asarray(tok)},
                                                max_new_tokens=5))
    got = ServeEngine(tm).generate(tp, {"tokens": t(tok).long()}, max_new_tokens=5)
    assert got.shape == (BATCH, 5)
    np.testing.assert_array_equal(n(got), want)


def test_jambas_local_dsgd_round_matches():
    one_round("jamba_v01_52b")
