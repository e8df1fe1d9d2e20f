"""Quickstart on the PyTorch port: the staged codec pipeline, end to end
on one weight update (the port's ``examples/quickstart.py``).

Walks the full paper pipeline through the port's API layers:
  codec stages (Selector → Quantizer → Encoder)  …  Alg. 2
  per-leaf policy (dense biases, SBC matrices)   …  DGC-style rules
  error feedback through compress()              …  Alg. 1 l.10-12 / Eq. 2
  packed wire bytes + measured-vs-analytic bits  …  Alg. 3/4, Eq. 1/5

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the CUDA card by default)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import golomb
from repro_torch.core.api import CompressionPolicy, PolicyRule, make_compressor
from repro_torch.core.codec import make_codec
from repro_torch.core.wire import wire_for
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default), cuda:N, or cpu")
dev = resolve_device(ap.parse_args().device)

# a fake "weight update": one matrix + one bias vector, from seeded generators
delta = {
    "layer0/w": torch.randn((512, 256), generator=torch.Generator(dev).manual_seed(0),
                            device=dev) * 0.01,
    "layer0/bias": torch.randn((256,), generator=torch.Generator(dev).manual_seed(1),
                               device=dev) * 0.01,
}

# --- 1. a codec is a composition of three registered stages
sbc = make_compressor("sbc")  # shim → topk_signed|binarize|golomb
print(f"SBC as a staged codec: {sbc.codec.spec}")

# --- 2. per-leaf policy: the bias rides dense, the matrix gets SBC
policy = CompressionPolicy(
    default=make_codec("sbc"),
    rules=(PolicyRule(r"bias$", codec="dense32"),),
    name="quickstart",
)
resolved = policy.resolve(delta)
print(resolved.describe())

# --- 3. compress with error feedback (paper Alg. 1 lines 10-12)
p = 0.01
state = resolved.init_state(delta)
rates = resolved.rates(p)
compressed, dense_update, state = resolved.compress(delta, state, rates)

leaf = compressed["layer0/w"]
n = delta["layer0/w"].numel()
print(f"\nmatrix: {n} params, sparsity p={p}")
print(f"survivors: {leaf.idx.shape[0]} positions, ONE value μ={float(leaf.mean):.6f}")
print(f"analytic wire size: {float(leaf.nbits):.0f} bits "
      f"(dense 32-bit: {32*n} bits → ×{32*n/float(leaf.nbits):.0f})")

# --- 4. exact wire format: pack the whole update to one byte buffer
wire = wire_for(resolved, delta, p)
blob = wire.pack(compressed)
measured = wire.measured_bits(compressed)
print(f"\npacked buffer: {len(blob)} bytes; measured payload {measured} bits "
      f"vs analytic {float(resolved.total_bits(compressed)):.0f} bits "
      f"(Eq. 5 predicts {golomb.expected_position_bits(p):.2f} bits/position)")

# --- 5. receiver side (Alg. 4): bytes → identical dense update
reconstructed = wire.unpack(blob)
for key in delta:
    np.testing.assert_allclose(reconstructed[key].numpy(),
                               dense_update[key].cpu().numpy(), rtol=1e-6)
print("receiver reconstruction matches ✓")

# --- 6. the residual keeps what was not sent (Eq. 2); the dense bias
#        leaf transmits in full, so its residual is exactly zero
res = state.residual["layer0/w"]
np.testing.assert_allclose((res + dense_update["layer0/w"]).cpu().numpy(),
                           delta["layer0/w"].cpu().numpy(), rtol=1e-5)
np.testing.assert_allclose(state.residual["layer0/bias"].cpu().numpy(), 0.0, atol=1e-7)
print("residual + transmitted == full update ✓ (no information lost)")
