"""The measured window's device trace, read from torch.profiler's
Chrome-trace export: device busy time, device time of the kernels
launched inside named host ranges, host time of ranges, launches, and the
breakdown of device operations and idle gaps.

Kernels are tied to the host op or `record_function` range that launched
them by their correlation id: a kernel belongs to a range when its
runtime launch call lies inside that range on the same host thread.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATS = ("user_annotation", "cpu_op")
# the record_function range that each runner opens around its window
WINDOW = "portbench/window"


class Trace:
    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                              and e.get("ph") == "X"), key=lambda e: e["ts"])
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.launch = {}
        for e in events:
            # the CUDA API calls that launch the kernels, which share a
            # correlation id with them
            if (e.get("cat", "").startswith("cuda_")
                    and "correlation" in e.get("args", {})):
                self.launch[e["args"]["correlation"]] = e
        self.ranges = defaultdict(list)
        for e in events:
            if e.get("cat") in RANGE_CATS and e.get("ph") == "X":
                self.ranges[e["name"]].append(e)
        win = self.ranges.get(WINDOW)
        if win:
            self.t0, self.t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
            self.window_s = win[0]["dur"] / 1e6
        else:
            self.t0, self.t1 = -float("inf"), float("inf")
        self.busy_s = self._busy() / 1e6

    def _merged(self):
        """The device's busy intervals inside the window, merged."""
        out = []
        for e in self.device:
            s = max(e["ts"], self.t0)
            t = min(e["ts"] + e.get("dur", 0), self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def _busy(self) -> float:
        return float(sum(t - s for s, t in self._merged()))

    def device_s_in(self, names) -> float:
        """Seconds of kernels launched inside the window and inside a host
        range or op named one of `names`, on the same thread."""
        spans = defaultdict(list)
        for name in names:
            for r in self.ranges.get(name, ()):
                spans[r.get("tid")].append((r["ts"], r["ts"] + r.get("dur", 0)))
        merged = {}
        for tid, ss in spans.items():
            out = []
            for s, t in sorted(ss):
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], t)
                else:
                    out.append([s, t])
            merged[tid] = ([s for s, _ in out], out)
        tot = 0.0
        for k in self.kernels:
            la = self.launch.get(k.get("args", {}).get("correlation"))
            if (la is None or la.get("tid") not in merged
                    or not self.t0 <= la["ts"] <= self.t1):
                continue
            starts, out = merged[la.get("tid")]
            i = bisect.bisect_right(starts, la["ts"]) - 1
            if i >= 0 and la["ts"] <= out[i][1]:
                tot += k.get("dur", 0)
        return tot / 1e6

    def _in_window(self, name):
        return [r for r in self.ranges.get(name, ())
                if self.t0 <= r["ts"] <= self.t1]

    def host_s(self, name) -> float:
        """Host seconds of the ranges named `name` that open in the
        window."""
        return sum(r.get("dur", 0) for r in self._in_window(name)) / 1e6

    def count(self, name) -> int:
        return len(self._in_window(name))

    def launches(self) -> int:
        """Kernels launched in the window."""
        return sum(1 for k in self.kernels
                   if (la := self.launch.get(k.get("args", {}).get("correlation")))
                   is not None and self.t0 <= la["ts"] <= self.t1)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        largest sums of idle device time by what the host was doing
        (the innermost named range open at the gap's start)."""
        ops = defaultdict(float)
        for e in self.device:
            ops[e["name"]] += e.get("dur", 0) / 1e6
        main = self.ranges[WINDOW][0].get("tid") if WINDOW in self.ranges \
            else None
        spans = sorted((r["ts"], r["ts"] + r.get("dur", 0), name)
                       for name, rs in self.ranges.items() if name != WINDOW
                       for r in rs if main is None or r.get("tid") == main)
        gaps = defaultdict(float)
        merged = self._merged()
        stack, j = [], 0
        for (_, end), (nxt, _) in zip(merged, merged[1:]):
            # the innermost span open at `end` on the window's thread
            while j < len(spans) and spans[j][0] <= end:
                while stack and stack[-1][1] < spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] < end:
                stack.pop()
            gaps[stack[-1][2] if stack else "host"] += (nxt - end) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile CPU and CUDA activity inside the block; yields a holder
    whose "trace" is the parsed Trace once the block has ended. Its
    window is the `WINDOW` range that the block opens, else the block."""
    holder = {"trace": None}
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        holder["trace"] = Trace(events, window)
