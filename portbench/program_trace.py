"""What the readers of the program's own spans and counts share, from the
window's trace (`trace.Trace`): the ranges that the window's thread opens
inside the window, the values of the counts that the program records as
zero-length ranges named `name=value` (`sednet_tpu_torch.utils.tracing.
count`: the Chrome export drops a range's arguments), and the device's
idle time under a span. Ranges of other threads are left out: the
program opens its spans on the thread that drives the work, and the
device idles there."""
from __future__ import annotations

from portbench.trace import WINDOW


def ranges(t, name: str) -> list:
    """The ranges named `name` that the window's thread opens inside the
    window."""
    win = t.ranges.get(WINDOW)
    if not win:
        return []
    tid = win[0].get("tid")
    return [r for r in t.ranges.get(name, ())
            if r.get("tid") == tid and t.t0 <= r["ts"] <= t.t1]


def counts(t, name: str) -> list:
    """The values of the count `name` recorded inside the window."""
    prefix = name + "="
    out = []
    for key in t.ranges:
        if key.startswith(prefix):
            out += [int(key[len(prefix):])] * len(ranges(t, key))
    return out


def host_s(t, name: str) -> float:
    """Host seconds of the spans named `name`."""
    return sum(r.get("dur", 0) for r in ranges(t, name)) / 1e6


def idle_s(t, name: str) -> float:
    """Seconds inside the window in which a span named `name` was open on
    the window's thread and no operation ran on the device (the device's
    busy intervals as `Trace` merges them)."""
    spans = []
    for s, e in sorted((r["ts"], r["ts"] + r.get("dur", 0))
                       for r in ranges(t, name)):
        s, e = max(s, t.t0), min(e, t.t1)
        if e <= s:
            continue
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    busy, i, idle = t._merged(), 0, 0.0
    for s, e in spans:
        idle += e - s
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            idle -= min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return idle / 1e6


def idle_ms_per(ctx, name: str, per: str):
    """Device-idle milliseconds under the span `name` over ctx[per] (the
    steps or the batches); None where the window holds no such span."""
    t = ctx.get("trace")
    if t is None or not ctx[per] or not ranges(t, name):
        return None
    return 1000.0 * idle_s(t, name) / ctx[per]


def mean_count(ctx, name: str):
    """The mean value of the count `name`; None where none was recorded."""
    t = ctx.get("trace")
    c = counts(t, name) if t is not None else []
    return sum(c) / len(c) if c else None
