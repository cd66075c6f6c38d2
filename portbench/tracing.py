"""Device traces of a few loops and what launched each device operation.

``capture`` runs a function under ``torch.profiler`` (the calls of the
program's ``utils/profiling.Trace``, with ``with_stack`` when asked), inside
the benchmark's own span ``portbench.window``, and reads the Chrome trace
back into a ``Segment``: every device operation (kernel, copy, fill) with

  - ``ops``: the host operations (``cpu_op``) open on the launching thread
    when it was launched, outermost first: a backward kernel sits under
    ``autograd::engine::evaluate_function: <Node>``;
  - ``frames``: the Python functions open there (``with_stack`` only);
  - ``fwd_frames``: for a backward kernel, the Python functions open where
    the forward operation with the same autograd sequence number ran, so
    that a cuBLAS GEMM of the backward is known by the module that made it.

Per-layer metrics pick their device operations from these by name
(``portbench/metrics/*.py``); this module names no layer.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation")
EVALUATE = "autograd::engine::evaluate_function"


@dataclass
class DeviceOp:
    name: str
    cat: str
    ts: float  # us
    dur: float  # us
    ops: tuple = ()
    frames: tuple = ()
    fwd_frames: tuple = ()

    def under(self, text: str) -> bool:
        """Whether a host operation open at its launch has ``text`` in its name."""
        return any(text in o for o in self.ops)

    def from_file(self, path: str) -> bool:
        """Whether it was launched (or, in the backward, its forward
        operation ran) inside a Python function of file ``path``."""
        return any(path in fr for fr in self.frames + self.fwd_frames)


@dataclass
class Segment:
    """A traced stretch of ``steps`` train steps."""

    ops: list
    start: float  # us, the benchmark's span
    end: float
    steps: int
    aten_ops: int
    host_at: list = field(default_factory=list)  # (ts, end, name) on the calling thread

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def union(self, ops) -> list:
        """The merged [start, end] intervals of ``ops`` inside the window.
        Kernels of one call may overlap (a chain launched by programmatic
        dependent launch waits on the device), so time is their union."""
        iv = sorted((max(o.ts, self.start), min(o.ts + o.dur, self.end)) for o in ops
                    if o.ts + o.dur > self.start and o.ts < self.end)
        merged: list = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_intervals(self) -> list:
        return self.union(self.ops)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def per_step_s(self, pick) -> float:
        """Device seconds a step in which an operation ``pick`` selects ran."""
        return sum(b - a for a, b in self.union(self.picked(pick))) * 1e-6 / self.steps

    def picked(self, pick) -> list:
        return [o for o in self.ops if pick(o)]

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time, by name (each name's
        union of intervals)."""
        by: dict = defaultdict(list)
        for o in self.ops:
            by[o.name[:120]].append(o)
        tops = [[k, sum(b - a for a, b in self.union(v)) * 1e-6] for k, v in by.items()]
        return sorted(tops, key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the device by what the calling thread was doing
        at each gap's middle: the innermost host operation open there, else
        ``python``."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        starts = [h[0] for h in self.host_at]
        by = Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "python"
            i = bisect.bisect_right(starts, mid)
            best = None
            for h in self.host_at[max(0, i - 64):i]:
                if h[0] <= mid <= h[1] and (best is None or h[0] >= best[0]):
                    best = h
            if best is not None:
                name = best[2]
            by[name[:120]] += (b - a) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]


def _open_at(intervals: list, queries: list) -> dict:
    """{query id: [interval, ...] open at its time}: intervals (ts, end, ...)
    on one thread, queries (t, id)."""
    items = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = {}, [], 0
    for t, qid in sorted(queries, key=lambda q: q[0]):
        while i < len(items) and items[i][0] <= t:
            while stack and stack[-1][1] < items[i][0]:
                stack.pop()
            stack.append(items[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[qid] = [iv for iv in stack if iv[1] >= t]
    return out


def parse(events: list, steps: int) -> Segment:
    window = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    start, end = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    main_tid = window[0]["tid"]
    host = defaultdict(list)  # tid -> [(ts, end, cat, name, args)]
    launches = {}  # correlation -> (tid, ts)
    device = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in HOST_CATS:
            host[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0), cat, e["name"],
                                   e.get("args", {})))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    queries = defaultdict(list)
    for corr, (tid, ts) in launches.items():
        queries[tid].append((ts, ("launch", corr)))
    fwd_ops = {}  # sequence number -> (tid, ts) of the outermost forward op
    for tid, ivs in host.items():
        for iv in ivs:
            args = iv[4]
            if iv[2] == "cpu_op" and "Sequence number" in args and not args.get("Fwd thread id"):
                seq = args["Sequence number"]
                if seq not in fwd_ops or iv[0] < fwd_ops[seq][1]:
                    fwd_ops[seq] = (tid, iv[0])
    for seq, (tid, ts) in fwd_ops.items():
        queries[tid].append((ts, ("fwd", seq)))
    opened = {}
    for tid, qs in queries.items():
        opened.update(_open_at(host.get(tid, []), qs))
    fwd_frames = {seq: tuple(iv[3] for iv in opened.get(("fwd", seq), [])
                             if iv[2] == "python_function") for seq in fwd_ops}
    ops = []
    for e in device:
        corr = e.get("args", {}).get("correlation")
        stack = opened.get(("launch", corr), [])
        names = tuple(iv[3] for iv in stack if iv[2] == "cpu_op")
        frames = tuple(iv[3] for iv in stack if iv[2] == "python_function")
        fwd = ()
        for iv in stack:
            if iv[2] == "cpu_op" and iv[3].startswith(EVALUATE):
                fwd = fwd_frames.get(iv[4].get("Sequence number"), ())
        ops.append(DeviceOp(e["name"], e["cat"], e["ts"], e.get("dur", 0), names, frames, fwd))
    aten = sum(1 for ivs in host.values() for iv in ivs
               if iv[2] == "cpu_op" and iv[3].startswith("aten::") and start <= iv[0] <= end)
    host_at = sorted((iv[0], iv[1], iv[3]) for iv in host.get(main_tid, []) if iv[2] == "cpu_op")
    host_at += [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                if e.get("cat") == "cuda_runtime" and e.get("tid") == main_tid
                and e.get("ph") == "X"]
    host_at.sort()
    return Segment(ops, start, end, steps, aten, host_at)


def capture(fn, steps: int, stack: bool, tmpdir: Path, cuda: bool = True) -> Segment:
    """Trace ``fn()`` (``steps`` train steps) and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities, with_stack=stack)
    with prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    path = Path(tmpdir) / f"portbench.{os.getpid()}.trace.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return parse(events, steps)
