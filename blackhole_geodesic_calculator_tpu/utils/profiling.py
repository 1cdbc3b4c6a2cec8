"""Profiler integration -- the reference's print-timers, upgraded to XProf.

The reference's only tracing is stdout wall-clock prints (SURVEY.md §5).
Here:

* ``trace(dir)`` captures a full device trace viewable in TensorBoard/XProf
  (kernel timelines, HBM traffic, fusion boundaries);
* ``annotate(name)`` scopes named regions so render phases (camera /
  integrate / shade) show up as labeled spans;
* ``profile_steps(fn, *args)`` + ``op_table(...)`` close the loop WITHOUT
  TensorBoard: run a jitted step under the tracer, parse the trace
  artifact, and return per-op device times -- the exact workflow that drove
  this framework's optimization rounds (backward-kernel share, texture
  scatter cost, host/device gap), available as one call.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: ``with trace('/tmp/trace'): render(...)``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span context for profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats():
    """Per-device live/peak HBM bytes (None entries where unsupported)."""
    out = {}
    for d in jax.devices():
        try:
            out[str(d)] = d.memory_stats()
        except Exception:
            out[str(d)] = None
    return out


def _load_trace_events(logdir: str):
    """All trace events from the newest .trace.json.gz under ``logdir``."""
    paths = sorted(glob.glob(
        os.path.join(logdir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not paths:
        raise FileNotFoundError(f"no trace artifact under {logdir}")
    with gzip.open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def op_table(logdir: str, top: int = 20, repeats: int = 1):
    """Per-op device-time table from a captured trace.

    Returns ``[(name, total_ms, count), ...]`` sorted by time, summed over
    the device-side complete events and divided by ``repeats`` (the number
    of identical steps traced).  Device process/threads are identified from
    the trace metadata, so this works on the GPU and on the CPU backend
    alike.
    """
    events = _load_trace_events(logdir)
    proc_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e["pid"]] = e["args"].get("name", "")
    device_pids = {pid for pid, name in proc_names.items()
                   if "GPU" in name or "device" in name.lower()}
    if not device_pids:
        # CPU backend: ops land on the host process, interleaved with
        # python-source spans -- keep XLA op events only
        device_pids = set(proc_names)
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("pid") in device_pids
                and not name.startswith("$") and ".py:" not in name):
            dur[name] += e.get("dur", 0)
            cnt[name] += 1
    rows = [(name, us / 1000.0 / repeats, cnt[name])
            for name, us in dur.most_common(top)]
    return rows


def profile_steps(fn, *args, repeats: int = 3, top: int = 20,
                  logdir: str | None = None):
    """Run ``fn(*args)`` ``repeats`` times under the tracer and return the
    per-op device-time table (ms per step).  ``fn`` should be jitted and
    warm (call it once first so compilation stays out of the trace)."""
    own = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="bgc_profile_")
    out = fn(*args)
    jax.block_until_ready(out)        # warmup / compile outside the trace
    with trace(logdir):
        for _ in range(repeats):
            out = fn(*args)
        jax.block_until_ready(out)
        jax.tree.map(lambda a: a.block_until_ready(), out)
    rows = op_table(logdir, top=top, repeats=repeats)
    if own:
        import shutil

        shutil.rmtree(logdir, ignore_errors=True)
    return rows


_COLLECTIVE_MARKERS = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all", "psum", "allreduce", "allgather",
)


def _device_complete_events(events):
    """Device-side 'X' (complete) events as (pid, name, ts, dur) tuples,
    using the same device-pid identification as op_table."""
    proc_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e["pid"]] = e["args"].get("name", "")
    device_pids = {pid for pid, name in proc_names.items()
                   if "GPU" in name or "device" in name.lower()}
    if not device_pids:
        device_pids = set(proc_names)
    out = []
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("pid") in device_pids
                and not name.startswith("$") and ".py:" not in name
                and "dur" in e):
            out.append((e["pid"], name, e["ts"], e["dur"]))
    return out


def _merge_intervals(ivals):
    ivals = sorted(ivals)
    out = []
    for s, t in ivals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap_us(ival, merged):
    """Length of ``ival`` covered by the merged interval list."""
    s, t = ival
    cov = 0.0
    for a, b in merged:
        if b <= s:
            continue
        if a >= t:
            break
        cov += min(b, t) - max(a, s)
    return cov


def collective_report(logdir: str, repeats: int = 1) -> dict:
    """Collective share and compute-overlap from a captured trace.

    Answers the BASELINE config-5 question ("gradient all-reduce overlapped
    with backward") with data: of all device-side op time, how much is
    collectives (all-reduce / all-gather / reduce-scatter / ...), and what
    fraction of collective WALL time runs concurrently with non-collective
    compute (on any device/core) -- i.e. how much of the communication the
    XLA scheduler hid behind compute.  Returns a dict with
    ``compute_ms``, ``collective_ms``, ``collective_share``,
    ``overlap_fraction`` (NaN when there are no collectives), and
    ``top_collectives`` [(name, ms), ...], all per step (divided by
    ``repeats``)."""
    import math

    evs = _device_complete_events(_load_trace_events(logdir))
    is_coll = lambda name: any(m in name.lower()
                               for m in _COLLECTIVE_MARKERS)
    coll = [(ts, ts + dur, name, dur) for _, name, ts, dur in evs
            if is_coll(name)]
    comp = [(ts, ts + dur) for _, name, ts, dur in evs if not is_coll(name)]
    coll_us = sum(d for *_, d in coll)
    comp_us = sum(t - s for s, t in comp)
    merged = _merge_intervals(comp)
    hidden = sum(_overlap_us((s, t), merged) for s, t, _, _ in coll)
    top = collections.Counter()
    for _, _, name, dur in coll:
        top[name] += dur
    return {
        "compute_ms": comp_us / 1e3 / repeats,
        "collective_ms": coll_us / 1e3 / repeats,
        "collective_share": (coll_us / (coll_us + comp_us)
                             if coll_us + comp_us else 0.0),
        "overlap_fraction": (hidden / coll_us) if coll_us else math.nan,
        "top_collectives": [(n, us / 1e3 / repeats)
                            for n, us in top.most_common(8)],
    }


def profile_collectives(fn, *args, repeats: int = 3) -> dict:
    """Run a warm jitted ``fn`` under the tracer and return
    ``collective_report`` of the capture."""
    logdir = tempfile.mkdtemp(prefix="bgc_coll_")
    try:
        out = fn(*args)
        jax.block_until_ready(out)
        with trace(logdir):
            for _ in range(repeats):
                out = fn(*args)
            jax.tree.map(lambda a: a.block_until_ready(), out)
        return collective_report(logdir, repeats=repeats)
    finally:
        import shutil

        shutil.rmtree(logdir, ignore_errors=True)


def format_op_table(rows) -> str:
    lines = [f"{'device ms/step':>14}  {'calls':>6}  op"]
    for name, ms, c in rows:
        lines.append(f"{ms:14.3f}  {c:6d}  {name[:80]}")
    return "\n".join(lines)
