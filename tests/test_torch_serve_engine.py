"""The port's serving engine (``repro_torch.serve.engine.ServeEngine``)
and its launcher (``repro_torch.launch.serve``) against the JAX
package's, on the CPU.

The reference's parameters cross with ``params_from_jax``; prompts come
from numpy with a seed.  Tolerances:
  * prefill logits and the caches' K/V: ``rtol=1e-5`` beside
    ``atol=1e-4`` (f32; the frameworks order a GEMM's adds differently);
    the caches' positions, shapes and tree: exact;
  * decode against a prefill of one more token: the reference's own
    ``test_decode_matches_prefill`` bound, 5% of the largest logit, and
    the port's decode against the reference's decode ``rtol=1e-4``;
  * greedy tokens: equal, token for token (each step's top logit leads
    the runner-up by far more than the logits' difference between the
    frameworks; the test checks that margin where it compares);
  * temperature sampling: its tokens are in range and repeat with the
    same generator (torch cannot draw JAX's threefry numbers).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model import build_model as j_build_model
from repro.run.presets import tiny_config as j_tiny
from repro.serve import ServeEngine as JServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten_with_path
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine
from test_torch_decoder import DENSE, close, port_cfg
from torch_helpers import n, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

CONFIGS = {"tiny": j_tiny, **{a: (lambda a=a: jbase.reduced(jbase.get_config(a)))
                              for a in DENSE}}


def engines(jcfg, seed=0):
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(port_cfg(jcfg))
    return JServeEngine(jm), jp, ServeEngine(tm), params_from_jax(jax.tree.map(np.asarray, jp),
                                                                  "cpu")


def prompts(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def jflat(tree):
    return {"/".join(getattr(k, "key", str(getattr(k, "idx", k))) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["tiny", "gemma3_1b"])
def test_prefill_logits_and_caches_match(name):
    """gemma3's reduced local window is 64: a 72-token prompt rolls it."""
    jcfg = CONFIGS[name]()
    je, jp, te, tp = engines(jcfg)
    tok = prompts(jcfg.vocab_size, 2, 72)
    jl, jc = je.prefill(jp, {"tokens": jnp.asarray(tok)})
    tl, tc = te.prefill(tp, {"tokens": torch.from_numpy(tok).long()})
    close(tl, jl, atol=1e-4, what="prefill logits")
    want = jflat(jc)
    got = {path_str(p): v for p, v in tree_flatten_with_path(tc)[0]}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        if k.endswith("pos"):
            np.testing.assert_array_equal(n(v), want[k], err_msg=k)
        else:
            close(v, want[k], atol=1e-4, what=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_prefill(name):
    jcfg = CONFIGS[name]()
    je, jp, te, tp = engines(jcfg, seed=1)
    S = 16
    tok = prompts(jcfg.vocab_size, 2, S, seed=1)
    nxt = np.ones((2, 1), np.int32)
    tm = te.model
    _, caches = tm.prefill(tp, {"tokens": torch.from_numpy(tok).long()})
    logits, _ = tm.decode_step(tp, torch.from_numpy(nxt).long(), caches, S)
    assert logits.shape == (2, 1, jcfg.vocab_size) and bool(torch.isfinite(logits).all())
    ref, _ = te.prefill(tp, {"tokens": torch.from_numpy(np.concatenate([tok, nxt], 1)).long()})
    err = float((logits - ref).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < 0.05, f"{name}: decode/prefill {err}"
    _, jc = je.model.prefill(jp, {"tokens": jnp.asarray(tok)})
    jlog, _ = je.model.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(S))
    close(logits, jlog, rtol=1e-4, atol=1e-4, what="decode vs reference decode")


def _margin(logits) -> float:
    top2 = np.sort(n(logits)[:, -1, :], axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


@pytest.mark.parametrize("name, S, new", [("tiny", 8, 6), ("gemma3_1b", 72, 6),
                                          ("tiny", 118, 16)],
                         ids=["tiny", "gemma3-rolling-window", "tiny-past-the-cache"])
def test_greedy_tokens_are_the_references(name, S, new):
    """The last case decodes positions 118-132 into full layers' caches of
    depth round128(118 + 8) = 128: positions 128-132 write slot 127, as
    the reference's clamp does (ROADMAP C), and the tokens still agree."""
    jcfg = CONFIGS[name]()
    je, jp, te, tp = engines(jcfg, seed=2)
    tok = prompts(jcfg.vocab_size, 2, S, seed=2)
    want = np.asarray(je.generate(jp, {"tokens": jnp.asarray(tok)}, max_new_tokens=new))
    got = te.generate(tp, {"tokens": torch.from_numpy(tok).long()}, max_new_tokens=new)
    assert got.dtype == torch.int64 and got.shape == (2, new)
    np.testing.assert_array_equal(n(got), want)
    logits, _ = te.prefill(tp, {"tokens": torch.from_numpy(tok).long()})
    assert _margin(logits) > 1e-3  # the first pick is no near-tie


def test_temperature_sampling_runs_in_range_and_repeats():
    jcfg = j_tiny()
    _, _, te, tp = engines(jcfg, seed=3)
    batch = {"tokens": torch.from_numpy(prompts(jcfg.vocab_size, 3, 8, seed=3)).long()}
    runs = [te.generate(tp, batch, max_new_tokens=12, temperature=1.0,
                        gen=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    for r in runs:
        assert r.shape == (3, 12) and int(r.min()) >= 0 and int(r.max()) < jcfg.vocab_size
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    greedy = te.generate(tp, batch, max_new_tokens=12)
    assert not torch.equal(runs[0], greedy)


def test_serve_launcher_runs_on_the_cpu():
    from repro_torch.launch.serve import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = main(["--arch", "gemma3-1b", "--batch", "2", "--prompt-len", "70",
                     "--new-tokens", "4", "--device", "cpu", "--subscribers", "50",
                     "--broadcast-rounds", "2"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("arch=gemma3-1b generated (2, 4) in ")
    assert lines[1].startswith("sample token ids: [")
    assert lines[2].startswith("broadcast: 50 subscribers x ")
    assert toks.shape == (2, 4) and int(toks.max()) < 512


def test_serve_launcher_without_a_card_raises_unless_cpu(monkeypatch):
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--new-tokens", "2"])
    # the MoE decoder, the encoder-decoder (over --prompt-len frames) and
    # the vision prefix serve now
    for arch in ("mixtral-8x7b", "seamless-m4t-medium", "phi-3-vision-4.2b"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            toks = main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--new-tokens", "3"])
        assert out.getvalue().startswith(f"arch={arch} generated (2, 3) in ")
        assert toks.shape == (2, 3) and int(toks.max()) < 512
