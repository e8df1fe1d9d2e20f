"""Does a lead-in of spin kernels inside the profiled window absorb the
records that torch.profiler loses?

    python3 tools/profiler_loss_lead_in.py [SECONDS]   # on a CUDA card; default 150

Profiles, over and over for SECONDS, windows of a one-kernel call (240 calls),
of 800 elementwise kernels a call (40 calls) and of a call that synchronises
every 10 operations (40 calls), each opened and closed by none, 16 + 16 or
256 + 16 short spin kernels (``torch.cuda._sleep``), or by one 10 ms spin
kernel at each end.  Prints the first lossy windows of each kind and, per kind,
the windows, the lossy ones, the records lost from the timed calls and from
the spin kernels.  ``chip_smoke.py``'s ``device_ms`` opens its windows so.
"""
import collections, sys, time
import torch
from torch.profiler import ProfilerActivity, profile

dev = "cuda"
x = torch.randn(1 << 12, device=dev)


def us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def many(n):
    def f():
        y = x
        for _ in range(n):
            y = y * 1.0001 + 0.5
        return y
    return f


def synced():
    y = x
    for i in range(40):
        y = y * 1.0001 + 0.5
        if i % 10 == 9:
            float(y[0])
    return y


FNS = {"one": (lambda: torch.sum(x), 240), "many400": (many(400), 40), "synced": (synced, 40)}
# (spin kernels before, cycles each, spin kernels after)
MODES = {"none": (0, 0, 0), "lead16": (16, 1000, 16), "lead256": (256, 1000, 16),
         "long10ms": (1, 20_000_000, 1)}
stats = collections.defaultdict(collections.Counter)
t0 = time.time()
budget = float(sys.argv[1]) if len(sys.argv) > 1 else 150
keys = set()
while time.time() - t0 < budget:
    for name, (fn, iters) in FNS.items():
        fn()
        for mode, (pre, cyc, post) in MODES.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(pre):
                    torch.cuda._sleep(cyc)
                for _ in range(iters):
                    fn()
                for _ in range(post):
                    torch.cuda._sleep(cyc)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if us(e) > 0]
            spin = sum(e.count for e in ev if "spin" in e.key)
            keys.update(e.key[:60] for e in ev if "spin" in e.key)
            body = [e.count for e in ev if "spin" not in e.key]
            lost = sum(abs(c - round(c / iters) * iters) for c in body)
            s = stats[f"{name} {mode}"]
            s["traces"] += 1
            s["lossy"] += lost > 0
            s["lost"] += lost
            s["spin_lost"] += pre + post - spin
            if lost and s["lossy"] <= 2:
                print(f"t={time.time() - t0:.1f}s {name} {mode}: body {body} spin {spin}/{pre + post}",
                      flush=True)
print(f"spin keys {keys}; torch {torch.__version__}; {time.time() - t0:.0f} s")
for k, s in stats.items():
    print(k, dict(s))
