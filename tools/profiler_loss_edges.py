"""Where does torch.profiler lose CUDA records: at the window's edges or inside?

    python3 tools/profiler_loss_edges.py [SECONDS]   # on a CUDA card; default 150

Profiles, over and over for SECONDS, windows of a one-kernel call (240 calls),
of 200 and 800 elementwise kernels a call (40 calls) and of a call that
synchronises every 10 operations (40 calls), each window opened by a cumsum and
closed by a flip, with 0, 5 and 50 ms of host sleep at both ends.  Prints the
first lossy windows of each kind and, per kind, the windows, their records,
the lossy ones, the records lost and how often the opening or closing marker
went missing.
"""
import collections, json, sys, time
import torch
from torch.profiler import ProfilerActivity, profile

dev = "cuda"
x = torch.randn(1 << 12, device=dev)
y16 = torch.randn(16, device=dev)


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


FNS = {"one": (lambda: torch.sum(x), 240), "many100": (many(100), 40),
       "many400": (many(400), 40), "synced": (synced, 40)}
PADS = [0.0, 0.005, 0.05]
stats = collections.defaultdict(lambda: collections.Counter())
t_start = time.time()
budget = float(sys.argv[1]) if len(sys.argv) > 1 else 150
cycle = 0
while time.time() - t_start < budget:
    for name, (fn, iters) in FNS.items():
        for _ in range(3):
            fn()
        for pad in PADS:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if pad:
                    time.sleep(pad)
                torch.cumsum(y16, 0)
                for _ in range(iters):
                    fn()
                torch.flip(y16, [0])
                torch.cuda.synchronize()
                if pad:
                    time.sleep(pad)
            ev = [e for e in prof.key_averages() if us(e) > 0]
            start = sum(e.count for e in ev if "cumsum" in e.key.lower() or "scan" in e.key.lower())
            end = sum(e.count for e in ev if "flip" in e.key.lower())
            body = [e.count for e in ev if not ("cumsum" in e.key.lower() or "scan" in e.key.lower() or "flip" in e.key.lower())]
            lost = sum(abs(c - round(c / iters) * iters) for c in body)
            s = stats[f"{name} pad {pad}"]
            s["traces"] += 1
            s["records"] += sum(body)
            s["lossy"] += lost > 0
            s["lost"] += lost
            s["no_start"] += start == 0
            s["no_end"] += end == 0
            if lost and s["lossy"] <= 3:
                print(f"t={time.time() - t_start:.1f}s {name} pad {pad}: counts {body} start {start} end {end}",
                      flush=True)
    cycle += 1
print(f"cycles {cycle}, torch {torch.__version__} cuda {torch.version.cuda}")
for k, s in stats.items():
    print(k, dict(s))
