"""Reduction of a `torch.profiler` trace to the numbers the per-layer
metrics read.

The profiler's kineto events are first flattened into plain tuples
(`from_profiler`); `summarize` works on those alone, so a test can feed it
a synthetic trace.

* Busy time is the union of the intervals in which any device activity
  (kernel, copy, fill) runs, on any stream. A sum of kernel times counts
  a collective that runs beside a product twice.
* Kernel classes: a kernel whose launch lies inside one of `MATMUL_OPS`
  on the launching thread is a product (`matmul_s`; `matmul_flops` are the
  FLOPs the profiler gives those ops); a kernel whose name holds "nccl" is
  communication (`nccl_s`); all else is `other_s`.
* Idle gaps are the holes in the busy union, each named by the innermost
  host op around the launch of the kernel that ended it: what the host was
  doing while the device waited.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple, Sequence

MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
DEVICE_KINDS = ("kernel", "memcpy", "memset")


class DeviceEvent(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    stream: int
    correlation: int


class HostEvent(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    correlation: int
    launch: bool          # a runtime call (a launch), not an op
    thread: int = 0
    flops: float = 0.0


def _kind(e, annotation) -> str:
    """'device', 'span', 'launch', 'op' or '' (ignored) for one kineto
    event, by its device, its name and whether it is a user annotation (a
    `record_function` range, which the profiler also draws on the device)."""
    name = e.name()
    annotated = e.is_user_annotation()
    if "cuda" in str(e.device_type()).lower():
        return "" if annotated or name == annotation else "device"
    if name == annotation:
        return "span"
    if annotated:
        return ""
    if name.startswith(("cuda", "cu")) and e.correlation_id():
        return "launch"
    return "op"


def from_profiler(prof, annotation: str | None = None):
    """(device events, host events, spans) of a finished
    `torch.profiler.profile`. `spans` are the intervals of the user
    annotation named `annotation` (none when it is None)."""
    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, annotation)
        if not kind:
            continue
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if kind == "device":
            device.append(DeviceEvent(e.name(), start, end,
                                      int(e.device_resource_id()),
                                      int(e.correlation_id())))
        elif kind == "span":
            spans.append((start, end))
        else:
            host.append(HostEvent(e.name(), start, end,
                                  int(e.correlation_id()), kind == "launch",
                                  int(e.start_thread_id()),
                                  float(e.flops() or 0)))
    return device, host, spans


def union(intervals: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    merged: list[list[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def _intersection(a: list, b: list) -> int:
    """Length of the overlap of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class _Enclosing:
    """Host ops of one thread, for the innermost op around an instant."""

    def __init__(self, ops: Sequence[HostEvent]):
        self.ops = sorted(ops, key=lambda h: h.start_ns)
        self.starts = [h.start_ns for h in self.ops]

    def innermost(self, at: int) -> HostEvent | None:
        """The latest-starting op that holds `at`, looking back 10 s."""
        for h in reversed(self.ops[: bisect.bisect_right(self.starts, at)]):
            if h.end_ns >= at:
                return h
            if at - h.start_ns > 10 ** 10:
                break
        return None


def _matmul_spans(host: Sequence[HostEvent]) -> dict:
    """Per thread, the outermost matmul ops as sorted (start, end, flops)."""
    by_thread = defaultdict(list)
    for h in sorted(host, key=lambda h: h.start_ns):
        if h.launch or h.name not in MATMUL_OPS:
            continue
        spans = by_thread[h.thread]
        if spans and h.start_ns < spans[-1][1]:
            continue                     # nested in the previous product
        spans.append((h.start_ns, h.end_ns, h.flops))
    return by_thread


def summarize(device: Sequence[DeviceEvent], host: Sequence[HostEvent],
              spans: Sequence[tuple[int, int]] = (), top: int = 10) -> dict:
    """The trace's numbers: busy union, class times, matmul FLOPs, the
    busy share of `spans`, the top device ops and the longest idle gaps."""
    busy = union([(e.start_ns, e.end_ns) for e in device])
    launches = {h.correlation: h for h in host if h.launch}
    products = _matmul_spans(host)
    starts = {t: [a for a, _, _ in v] for t, v in products.items()}

    def is_matmul(e: DeviceEvent) -> bool:
        launch = launches.get(e.correlation)
        if launch is None or launch.thread not in products:
            return False
        i = bisect.bisect_right(starts[launch.thread], launch.start_ns) - 1
        return i >= 0 and launch.start_ns <= products[launch.thread][i][1]

    kernel_ns = nccl_ns = matmul_ns = 0
    by_name: dict[str, int] = defaultdict(int)
    for e in device:
        ns = e.end_ns - e.start_ns
        kernel_ns += ns
        by_name[e.name] += ns
        if "nccl" in e.name.lower():
            nccl_ns += ns
        elif is_matmul(e):
            matmul_ns += ns
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    threads = defaultdict(list)
    for h in host:
        if not h.launch:
            threads[h.thread].append(h)
    enclosing = {t: _Enclosing(ops) for t, ops in threads.items()}
    ordered = sorted(device, key=lambda e: e.start_ns)
    device_starts = [e.start_ns for e in ordered]
    gaps = sorted(((nxt - end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])),
                  reverse=True)[:top]
    idle = []
    for length, nxt in gaps:
        kernel = ordered[bisect.bisect_left(device_starts, nxt)]
        launch = launches.get(kernel.correlation)
        op = enclosing[launch.thread].innermost(launch.start_ns) \
            if launch is not None and launch.thread in enclosing else None
        idle.append([op.name if op else (launch.name if launch else "host"),
                     length / 1e9])

    span_union = union(spans)
    return {
        "busy_s": _length(busy) / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "nccl_s": nccl_ns / 1e9,
        "matmul_s": matmul_ns / 1e9,
        "matmul_flops": sum(f for v in products.values() for _, _, f in v),
        "other_s": (kernel_ns - nccl_ns - matmul_ns) / 1e9,
        "span_s": _length(span_union) / 1e9,
        "busy_in_spans_s": _intersection(busy, span_union) / 1e9,
        "device_ops": [[name, ns / 1e9] for name, ns in top_ops],
        "idle_gaps": idle,
        "ranks": 1,
    }


def merge_ranks(summaries: Sequence[dict]) -> dict:
    """One summary over several ranks' traces: times and FLOPs summed,
    the device ops and idle gaps of all ranks merged and cut to the top."""
    out = {key: sum(s[key] for s in summaries)
           for key in ("busy_s", "kernel_s", "nccl_s", "matmul_s",
                       "matmul_flops", "other_s", "span_s", "busy_in_spans_s")}
    ops: dict[str, float] = defaultdict(float)
    for s in summaries:
        for name, sec in s["device_ops"]:
            ops[name] += sec
    out["device_ops"] = [[n, v] for n, v in
                         sorted(ops.items(), key=lambda kv: -kv[1])[:10]]
    gaps = [g for s in summaries for g in s["idle_gaps"]]
    out["idle_gaps"] = sorted(gaps, key=lambda g: -g[1])[:10]
    out["ranks"] = len(summaries)
    return out
