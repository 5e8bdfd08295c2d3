"""Reduce a jax.profiler trace to device time.

Reads the newest `.xplane.pb` under a trace directory with nothing but JAX
(jax.profiler.ProfileData) and sums the device (GPU) kernel events: busy
time as the union of intervals on each device, time per jitted program
(the `hlo_module` stat), and time under `jax.named_scope` spans, found in
the op name that XLA records for each kernel.
"""
from __future__ import annotations

import glob
import os


def newest_xplane(trace_dir):
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def device_events(path):
    """[(device, line, name, start_ns, dur_ns, stats)] for every event on a
    GPU device plane; stats maps stat name -> value."""
    from jax.profiler import ProfileData
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((plane.name, line.name, ev.name, ev.start_ns,
                            ev.duration_ns, dict(ev.stats)))
    return out


def _busy_ns(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _text(stats):
    return " ".join(str(v) for v in stats.values() if isinstance(v, str))


def summarize(events, scopes=(), module_filter=None, depth=4):
    """Device time of the kernels in `events`. module_filter: keep only
    kernels whose hlo_module stat contains this string. Returns
    {"window_ns", "busy_ns", "kernel_ns", "by_module", "by_scope",
    "by_kernel", "by_op"} — by_scope sums the kernels whose recorded op names
    contain "/<scope>/" or end in "/<scope>"; by_kernel and by_op hold the 40
    largest kernels by kernel name and by the op-name path XLA records for
    each kernel (the `name` stat, cut to `depth` components)."""
    ev = [e for e in events
          if module_filter is None
          or module_filter in str(e[5].get("hlo_module", ""))]
    if not ev:
        return {"window_ns": 0, "busy_ns": 0, "kernel_ns": 0,
                "by_module": {}, "by_scope": {}, "by_kernel": {}, "by_op": {}}
    per_dev = {}
    by_module, by_scope, by_kernel, by_op = {}, {s: 0.0 for s in scopes}, {}, {}
    for dev, _, name, s, d, st in ev:
        per_dev.setdefault(dev, []).append((s, s + d))
        mod = str(st.get("hlo_module", "?"))
        by_module[mod] = by_module.get(mod, 0.0) + d
        by_kernel[name] = by_kernel.get(name, 0.0) + d
        # the fused op's name path (recorded when XLA runs kernels outside
        # command buffers), cut to its first `depth` components
        op = "/".join(str(st.get("name", "?")).split("/")[:depth])
        by_op[op] = by_op.get(op, 0.0) + d
        txt = _text(st)
        for sc in scopes:
            if f"/{sc}/" in txt or txt.endswith(f"/{sc}") or \
                    f"/{sc} " in txt:
                by_scope[sc] += d
    t0 = min(e[3] for e in ev)
    t1 = max(e[3] + e[4] for e in ev)

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:40])

    return {"window_ns": t1 - t0,
            "busy_ns": sum(_busy_ns(v) for v in per_dev.values()),
            "kernel_ns": sum(e[4] for e in ev),
            "by_module": dict(sorted(by_module.items(),
                                     key=lambda kv: -kv[1])),
            "by_scope": by_scope, "by_kernel": top(by_kernel),
            "by_op": top(by_op)}
