"""Roofline terms of one step counted on the ``meta`` device (no card).

Counterpart of ``repro.launch.roofline``:

    compute term    = FLOPs per device / peak FLOP/s of their dtype
    memory term     = bytes per device / HBM rate
    collective term = Σ per-collective ring-weighted bytes / link rate

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
the collectives from the optimized HLO.  The port has neither, so
:class:`StepCounter`, a ``TorchDispatchMode``, counts them while one
rank's step runs on ``meta`` tensors (:mod:`repro_torch.launch.dryrun`):

  * FLOPs: the per-op formulas of ``torch.utils.flop_counter`` (the
    registry ``FlopCounterMode`` reads: ``2·m·n·k`` a GEMM, the
    attention products, convolutions), kept by the dtype of the op's
    first operand;
  * bytes: each op's input and output bytes (views and fresh
    allocations move none);
  * memory: the bytes of the live storages the step made, tracked through
    their lifetimes (a storage counts from the op that makes it to its
    release), and their peak;
  * collectives: the recording group's calls
    (``repro_torch.launch.dryrun.RecordingGroup``), priced by
    :func:`collective_stats` with the reference's ring factors for a
    group of N ranks:

        all-reduce      2·(N−1)/N
        all-gather      (N−1)/N   (the gathered output's bytes)
        reduce-scatter  (N−1)/N
        all-to-all      (N−1)/N
        collective-permute  1

    A group whose ranks differ in the "pod" coordinate alone crosses
    nodes: its bytes are priced at :data:`DCN_BW`, the rest at
    :data:`ICI_BW`.

A host loop over sequence positions (the Mamba and RWKV6 recurrences,
``repro_torch.models.hints.steps``) may run two steps for all of them
under :class:`LoopSampler`: the second step's ops, in the forward and
(through hooks on its autograd nodes) in the backward, count once for
each of the positions after the first, and so do the storages it leaves
alive.

Hardware terms: NVIDIA H100 SXM5 80 GB, from its datasheet.  They are
assumptions, not measurements of this card: dense bf16 tensor-core peak
989 TFLOP/s; f32 without TF32 67 TFLOP/s (the port's f32 GEMMs run with
TF32 off, ``repro_torch.device.full_f32_math``); HBM3 3.35 TB/s; NVLink
450 GB/s a direction a GPU; 50 GB/s a GPU across nodes (400 Gb/s NDR
InfiniBand), for the "pod" axis.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80 GB datasheet terms (assumptions, not measurements)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12  # f32 FLOP/s with TF32 off
HBM_BW = 3.35e12  # HBM3 bytes/s
ICI_BW = 450e9  # NVLink bytes/s a direction a GPU (the reference's ICI term)
DCN_BW = 50e9  # bytes/s a GPU across nodes, 400 Gb/s NDR (the reference's DCN term)

_HALF = {torch.bfloat16, torch.float16}
# ops that allocate or describe a tensor without reading or writing its data
# (an allocation's storage still counts as live memory)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
               torch.ops.aten.detach, torch.ops.aten.lift_fresh}


def peak_flops(dtype: torch.dtype) -> float:
    """The datasheet peak of GEMMs in ``dtype``: bf16/f16 on the tensor
    cores, anything else at the f32 rate without TF32."""
    return PEAK_FLOPS if dtype in _HALF else PEAK_FLOPS_F32


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs (tensors, lists, tuples
    and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    todo = [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """FLOPs by dtype, bytes and the live bytes of the storages a step makes
    (see the module docstring).  :meth:`exclude` the step's arguments
    first: their storages (and views of them) are not the step's."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: dict = {}  # dtype name → FLOPs
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.weight = 1  # a sampled loop step's ops count this many times
        # storage key (its address, reused once it is freed) → [bytes it
        # counts for, the serial number of its tracking]
        self._alive: dict = {}
        self._serial = 0
        self._made: Optional[list] = None  # (key, serial) of a sampled step's storages

    def exclude(self, tree) -> None:
        for t in _tensors(tree):
            self._alive.setdefault(t.untyped_storage()._cdata, [0, -1])

    def alive(self, key: int, serial: int) -> int:
        """The bytes a storage tracked as ``(key, serial)`` counts for while
        it lives, else 0."""
        got = self._alive.get(key)
        return got[0] if got is not None and got[1] == serial else 0

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, [0])[0]

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in inputs or key in self._alive:
            return
        n = st.nbytes()
        self._serial += 1
        self._alive[key] = [n, self._serial]
        self.live += n
        weakref.finalize(st, self._free, key)
        if self._made is not None:
            self._made.append((key, self._serial))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        w = self.weight
        self.ops += w
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        if packet in flop_registry:
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "float32"
            self.flops[dt] = self.flops.get(dt, 0) + w * flop_registry[packet](
                *args, **kwargs, out_val=out)
        if func.is_view:
            return out
        outs = _tensors(out)
        if packet not in _NO_TRAFFIC:
            self.bytes += w * (sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t, keys)
        self.peak = max(self.peak, self.live)
        return out

    def compute_s(self) -> float:
        return sum(f / peak_flops(getattr(torch, dt)) for dt, f in self.flops.items())

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


class LoopSampler:
    """Two steps of a host loop over n positions stand for all n
    (:func:`repro_torch.models.hints.steps`): step 0 runs as it is, and
    step 1, which reads a carried state that a step has written, counts
    n − 1 times: its forward ops in ``counter`` (and the calls it makes in
    ``tallies``, objects with ``weight``), its autograd nodes' backward ops
    (pre and post hooks on each node it made) and each storage it leaves
    alive, but the carried state, until that storage is released; its
    peak counts as the last step's (:meth:`steps`).  ``loops`` records
    each sampled loop's trip count."""

    def __init__(self, counter: StepCounter, tallies: Sequence = ()) -> None:
        self.counter, self.tallies = counter, tuple(tallies)
        self.loops: list = []
        self._window: Optional[tuple] = None

    def _set_weight(self, w: int) -> None:
        self.counter.weight = w
        for t in self.tallies:
            t.weight = w

    @staticmethod
    def _seq() -> int:
        with torch.enable_grad():
            return torch.empty(0, requires_grad=True).clone().grad_fn._sequence_nr()

    def steps(self, n: int):
        """A generator of steps 0 and 1 for a loop of ``n`` (> 2) steps.
        The peak inside step 1 is taken again as the last step's: beside
        the storages that n − 2 more steps leave alive, each as many bytes
        as step 0 left alive after step 1 (its outputs and saved tensors;
        not the state step 1 replaced)."""
        c = self.counter
        outer, c._made = c._made, []
        yield 0
        made0, c._made = c._made, []
        seq0 = self._seq()
        peak, c.peak = c.peak, c.live  # the peak inside step 1 alone
        self._set_weight(n - 1)
        try:
            yield 1
        finally:
            self._set_weight(1)
            made1, c._made = c._made, outer
            inside, c.peak = c.peak, max(peak, c.peak)
            if outer is not None:
                outer.extend(made0 + made1)
        kept = sum(c.alive(*made) for made in made0)
        c.peak = max(c.peak, inside + (n - 2) * kept)
        self.loops.append(n)
        self._window = (seq0, n - 1, made1)

    def every_step(self, outs: list, n: int, carries: Sequence) -> list:
        """The loop's outputs, one a position (step 1's for steps 1 to n −
        1); the storages step 1 left alive but its ``carries`` (the state
        the next step replaces) counted n − 1 times; and hooks on the
        backward of step 1's autograd nodes (those reachable from ``outs``
        and ``carries`` made after it began)."""
        if len(outs) == n or self._window is None:
            return outs
        seq0, w, made = self._window
        self._window = None
        c = self.counter
        carried = {t.untyped_storage()._cdata for t in carries if isinstance(t, torch.Tensor)}
        for key, serial in made:
            n = c.alive(key, serial)
            if n and key not in carried:
                c.live += (w - 1) * n
                c._alive[key][0] = w * n
        c.peak = max(c.peak, c.live)
        seen, todo = set(), [t.grad_fn for t in list(outs[1:]) + list(carries)
                             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or node in seen or type(node).__name__ == "AccumulateGrad":
                continue
            if node._sequence_nr() <= seq0:
                continue
            seen.add(node)
            node.register_prehook(lambda grads, w=w: self._set_weight(w))
            node.register_hook(lambda gin, gout: self._set_weight(1))
            todo.extend(f for f, _ in node.next_functions)
        return [outs[0]] + [outs[1]] * w


# ------------------------------------------------------------ collectives


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float = 0.0  # Σ bytes·ring factor (per device)
    pod_bytes: float = 0.0  # the part over groups that cross the "pod" axis
    by_kind: Optional[dict] = None
    count: int = 0


_RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n, "collective-permute": lambda n: 1.0}


def collective_stats(calls: Sequence[dict], *, pod_groups: Sequence[tuple] = (),
                     scale: Optional[Sequence[int]] = None) -> CollectiveStats:
    """Ring-weighted bytes of recorded calls (dicts with ``kind``, ``bytes``
    — the gathered or exchanged output's — and ``members``, the group's
    global ranks).  A call whose members are one of ``pod_groups`` crosses
    nodes.  ``scale`` gives each call's count (a sampled loop's calls)."""
    stats = CollectiveStats(by_kind={})
    pods = {tuple(g) for g in pod_groups}
    for i, c in enumerate(calls):
        n = len(c["members"])
        if n <= 1:
            continue
        factor = _RING.get(c["kind"], lambda n: (n - 1) / n)(n)
        contrib = c["bytes"] * factor * (scale[i] if scale is not None else 1)
        stats.total_bytes += contrib
        stats.count += 1
        stats.by_kind[c["kind"]] = stats.by_kind.get(c["kind"], 0.0) + contrib
        if tuple(c["members"]) in pods:
            stats.pod_bytes += contrib
    return stats


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    hbm_bytes: float  # per device
    coll: CollectiveStats
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6·N_active·D (whole step, all devices)
    useful_ratio: float  # model_flops / (flops · n_devices)

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll.total_bytes,
            "collective_by_kind": self.coll.by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def analyze(counter: StepCounter, coll: CollectiveStats, *, n_devices: int,
            model_flops: float, kernel_bytes: float = 0.0) -> Roofline:
    """The three terms of one rank's step: ``counter``'s FLOPs and bytes
    (plus ``kernel_bytes``, the hand kernels' bound bytes, which no aten op
    carries), ``coll``'s collective bytes."""
    flops = counter.total_flops
    hbm = float(counter.bytes + kernel_bytes)
    compute_s = counter.compute_s()
    memory_s = hbm / HBM_BW
    collective_s = (coll.total_bytes - coll.pod_bytes) / ICI_BW + coll.pod_bytes / DCN_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / max(flops * n_devices, 1.0)
    return Roofline(flops, hbm, coll, compute_s, memory_s, collective_s, dominant,
                    model_flops, useful)


def model_flops_for(cfg, shape: dict, kind: str) -> float:
    """6·N_active·D for training; 2·N_active·D for inference forward."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape["global_batch"] * shape["seq_len"]
        return 2.0 * n_active * tokens
    # decode: ONE token per sequence
    return 2.0 * n_active * shape["global_batch"]
