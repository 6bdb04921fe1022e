"""Attribution of a `torch.profiler` trace to the program's own spans.

The port marks its work with `record_function` ranges named ``ko.*``
(`kubeoperator_tpu_torch/utils/spans.py`). This module puts each device
activity of a finished trace down to one of those ranges and sums, per
span name, the device time, the host time and the count. It reads the
profiler's events only and imports nothing of the port. As in
`kobench/trace.py`, the events are first flattened into plain tuples
(`from_profiler`), so a test can feed `summarize` a synthetic trace.

* Forward: a kernel belongs to the innermost ``ko.*`` range that holds
  its launch on the launching thread.
* Backward: autograd launches backward kernels inside a node (an op named
  ``*Backward*``) that carries the sequence number of the forward op it
  differentiates and that op's thread (``fwd_thread``). A kernel launched
  inside such a node belongs to the innermost ``ko.*`` range that held the
  forward op, whichever thread ran the node.
* A span's device time is the union of the intervals of the kernels that
  belong to it or to a range nested inside it. Device time that no range
  claims is `unclaimed_s`.
* A span's host time is the length of its ranges; its runtime time is the
  time inside CUDA runtime calls (launches, copies) that start within its
  ranges, on any thread (the calling thread waits while autograd's thread
  launches the backward). A runtime call waits whenever the launch queue is
  full, so the calls of one name take either their own cost (a few to tens
  of microseconds) or that plus a wait for a kernel to end. A name's
  unblocked cost is the median of its calls that take at most ten times its
  fastest; a span's blocked time is the excess of each of its calls over
  that cost. The host time less the blocked time is the host's own work,
  launches included.
* Idle gaps are the holes in the busy union, each named
  ``<span>/<host op>`` by the kernel that ended it: the span it belongs to
  (``entry`` when none) and the innermost host op around its launch, named
  as `kobench/trace.py` names it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple, Sequence

from kobench.trace import DeviceEvent, _kind, union

PREFIX = "ko."


class Op(NamedTuple):
    """A host op or a runtime call (`launch`) with autograd's sequence
    number (-1: none) and, for a backward node, its forward op's thread
    (0: none)."""

    name: str
    start_ns: int
    end_ns: int
    correlation: int
    launch: bool
    thread: int
    seq: int = -1
    fwd_thread: int = 0


class Range(NamedTuple):
    """One ``ko.*`` range on its host thread."""

    name: str
    start_ns: int
    end_ns: int
    thread: int


def from_profiler(prof):
    """(device events, host ops, ``ko.*`` ranges) of a finished
    `torch.profiler.profile`."""
    device, host, ranges = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        on_device = "cuda" in str(e.device_type()).lower()
        if not on_device and e.is_user_annotation() and name.startswith(PREFIX):
            ranges.append(Range(name, start, end, int(e.start_thread_id())))
            continue
        kind = _kind(e, None)
        if kind == "device":
            device.append(DeviceEvent(name, start, end,
                                      int(e.device_resource_id()),
                                      int(e.correlation_id())))
        elif kind:
            host.append(Op(name, start, end, int(e.correlation_id()),
                           kind == "launch", int(e.start_thread_id()),
                           int(e.sequence_nr()), int(e.fwd_thread_id())))
    return device, host, ranges


def _parents(ranges: Sequence[Range]) -> dict:
    """{range: the range it is nested in, or None}, by intervals on each
    thread."""
    parent = {}
    stacks: dict[int, list] = defaultdict(list)
    for r in sorted(ranges, key=lambda r: (r.start_ns, -r.end_ns)):
        stack = stacks[r.thread]
        while stack and stack[-1].end_ns <= r.start_ns:
            stack.pop()
        parent[r] = stack[-1] if stack else None
        stack.append(r)
    return parent


class _Enclosing:
    """Events of one thread, for the innermost one around an instant.
    `trace.py`'s copies the list up to the instant on every look-up, which
    is too slow for one look-up a kernel."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e.start_ns)
        self.starts = [e.start_ns for e in self.events]

    def innermost(self, at: int):
        """The latest-starting event that holds `at`, looking back 10 s."""
        i = bisect.bisect_right(self.starts, at) - 1
        while i >= 0 and at - self.starts[i] <= 10 ** 10:
            if self.events[i].end_ns >= at:
                return self.events[i]
            i -= 1
        return None


def _by_thread(events) -> dict:
    threads = defaultdict(list)
    for e in events:
        threads[e.thread].append(e)
    return {t: _Enclosing(v) for t, v in threads.items()}


def unblocked_cost(calls: Sequence[Op]) -> dict:
    """{runtime call name: its cost when it finds room in the launch
    queue}: the median of its calls that take at most ten times its
    fastest. A call that waits waits for a kernel to end, which on a
    filled card takes far longer than the call itself."""
    durations: dict[str, list] = defaultdict(list)
    for h in calls:
        durations[h.name].append(h.end_ns - h.start_ns)
    cost = {}
    for name, ns in durations.items():
        fast = sorted(d for d in ns if d <= 10 * min(ns))
        cost[name] = fast[(len(fast) - 1) // 2]
    return cost


def _backward_node(op: Op) -> bool:
    return op.seq >= 0 and op.fwd_thread > 0 and "Backward" in op.name


def summarize(device: Sequence[DeviceEvent], host: Sequence[Op],
              ranges: Sequence[Range], top: int = 10) -> dict:
    """Per span name its device time (nested spans included), host time,
    runtime time, blocked time and count; the device time no span claims; the longest
    idle gaps named by span and host op."""
    launches = {h.correlation: h for h in host if h.launch}
    ops = [h for h in host if not h.launch]
    enclosing_op = _by_thread(ops)
    nodes = _by_thread([h for h in ops if _backward_node(h)])
    enclosing_range = _by_thread(ranges)
    parent = _parents(ranges)
    # the forward op of each (thread, sequence number): the latest-starting
    # op that carries it, as an outer op shares the number of the first op
    # inside it that records a node, and the profiler's own range ops take
    # the next number without recording one
    forward: dict[tuple[int, int], Op] = {}
    for h in sorted(ops, key=lambda h: h.start_ns):
        if h.seq >= 0 and not h.fwd_thread and not h.name.startswith("profiler::"):
            forward[(h.thread, h.seq)] = h

    def innermost_range(thread: int, at: int) -> Range | None:
        found = enclosing_range.get(thread)
        return found.innermost(at) if found else None

    def owner(e: DeviceEvent) -> Range | None:
        launch = launches.get(e.correlation)
        if launch is None:
            return None
        node = nodes[launch.thread].innermost(launch.start_ns) \
            if launch.thread in nodes else None
        if node is not None:
            fwd = forward.get((node.fwd_thread, node.seq))
            return innermost_range(fwd.thread, fwd.start_ns) if fwd else None
        return innermost_range(launch.thread, launch.start_ns)

    owners = [owner(e) for e in device]
    intervals: dict[str, list] = defaultdict(list)
    claimed = []
    for e, r in zip(device, owners):
        if r is not None:
            claimed.append((e.start_ns, e.end_ns))
        while r is not None:
            intervals[r.name].append((e.start_ns, e.end_ns))
            r = parent[r]

    cost = unblocked_cost([h for h in host if h.launch])
    calls = sorted((h.start_ns, h.end_ns - h.start_ns, cost[h.name])
                   for h in host if h.launch)
    call_starts = [a for a, _, _ in calls]
    call_ns, blocked_ns = [0], [0]
    for _, ns, own in calls:
        call_ns.append(call_ns[-1] + ns)
        blocked_ns.append(blocked_ns[-1] + max(ns - own, 0))
    spans: dict[str, dict] = {}
    for r in ranges:
        s = spans.setdefault(r.name, {"device_s": 0.0, "host_s": 0.0,
                                      "runtime_s": 0.0, "blocked_s": 0.0,
                                      "count": 0})
        s["host_s"] += (r.end_ns - r.start_ns) / 1e9
        first = bisect.bisect_left(call_starts, r.start_ns)
        last = bisect.bisect_right(call_starts, r.end_ns)
        s["runtime_s"] += (call_ns[last] - call_ns[first]) / 1e9
        s["blocked_s"] += (blocked_ns[last] - blocked_ns[first]) / 1e9
        s["count"] += 1
    for name, iv in intervals.items():
        spans[name]["device_s"] = sum(b - a for a, b in union(iv)) / 1e9

    busy = union([(e.start_ns, e.end_ns) for e in device])
    busy_ns = sum(b - a for a, b in busy)
    claimed_ns = sum(b - a for a, b in union(claimed))

    order = sorted(range(len(device)), key=lambda i: device[i].start_ns)
    starts = [device[i].start_ns for i in order]
    gaps = sorted(((nxt - end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])),
                  reverse=True)[:top]
    idle = []
    for length, nxt in gaps:
        i = order[bisect.bisect_left(starts, nxt)]
        launch = launches.get(device[i].correlation)
        op = enclosing_op[launch.thread].innermost(launch.start_ns) \
            if launch is not None and launch.thread in enclosing_op else None
        where = owners[i].name if owners[i] is not None else "entry"
        what = op.name if op else (launch.name if launch else "host")
        idle.append([f"{where}/{what}", length / 1e9])

    return {"spans": spans, "busy_s": busy_ns / 1e9,
            "claimed_s": claimed_ns / 1e9,
            "unclaimed_s": (busy_ns - claimed_ns) / 1e9, "idle_gaps": idle}
