"""End-to-end run on the PyTorch port: train a ~100M-parameter decoder
LM with DSGD + SBC for a few hundred communication rounds (the port's
``examples/train_lm_100m.py``).

Four clients jointly train on a synthetic Markov corpus; SBC(2)-style
settings (delay 10, p = 1%).  Prints the loss curve and the measured
upload compression vs 32-bit dense DSGD.

Run:  PYTHONPATH=src python examples/torch_train_lm_100m.py [--rounds 30]
[--device cuda] (the CUDA card by default; lm-100m's task alone is a
32,000² f32 table, so this is a run for the card)
"""
import argparse
import math
import os

from repro_torch.launch.train import main as train_main
from repro_torch.paths import experiments_dir

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--delay", type=int, default=10)
    ap.add_argument("--sparsity", type=float, default=0.01)
    ap.add_argument("--device", default=None, help="cuda (default), cuda:N, or cpu")
    args = ap.parse_args()

    history = os.path.join(experiments_dir("examples_torch"), "lm100m_history.json")
    hist = train_main([
        "--preset", "lm-100m",
        "--compressor", "sbc",
        "--clients", "4",
        "--delay", str(args.delay),
        "--sparsity", str(args.sparsity),
        "--rounds", str(args.rounds),
        "--batch", "4",
        "--seq-len", "128",
        "--log-every", "5",
        "--history", history,
        *(["--device", args.device] if args.device else []),
    ])
    assert all(math.isfinite(x) for x in hist["loss"]) and hist["compression_rate"] > 1
    print(f"{args.rounds} rounds, every loss finite, upload compressed "
          f"×{hist['compression_rate']:.0f} ✓")
