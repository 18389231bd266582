"""The benchmark's machinery, shared by every cell: the manifest and the
files it names, the closed-loop window, the host spans, the profiler's
trace and its reduction, the comparison's verdict and the result line.

A cell is found by name: ``portbench/workloads/<cell>.json`` names its
configuration (``portbench/configs/<config>.json``) and its driver
(``portbench/drivers/<driver>.py``); the metrics it reports are the
entries of ``BENCHMARK.json`` that list it (or list no cells and move an
end-to-end metric the cell reports), each per-layer metric read by
``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
F32_PEAK = 67e12          # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FORBIDDEN = ("jax", "jaxlib", "flax", "stlpose_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


def read_json(path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str) -> dict:
    """{name, workload, config, driver module}: the cell's files."""
    wl = read_json(os.path.join(PKG, "workloads", f"{name}.json"))
    cfg = read_json(os.path.join(PKG, "configs", f"{wl['config']}.json"))
    return {"name": name, "workload": wl, "config": cfg,
            "driver": load_module("drivers", wl["driver"])}


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(PKG, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, cell: str, reported: set):
    """(end-to-end names, per-layer entries) that ``cell`` reports, given
    the end-to-end metrics its driver measures."""
    e2e = [m["name"] for m in man["end_to_end"]
           if (cell in m["workloads"] if "workloads" in m
               else m["name"] in reported)]
    e2e_set = set(e2e)
    layers = [m for m in man["per_layer"]
              if (cell in m["workloads"] if "workloads" in m
                  else m["moves"] in e2e_set)]
    return e2e, layers


def sub_seed(seed: int, tag: str) -> int:
    """A 31-bit seed for one stream of the run, from --seed and a tag."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2 ** 31 - 1)


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def percentile(values, q: float) -> float:
    """The q-th percentile, nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def card_info(torch):
    """(name, power limit in W or None) of the current card."""
    name = torch.cuda.get_device_name()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        limit = None
    return name, limit


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ----------------------------------------------------------------- spans
class Spans:
    """Host spans the drivers open around the program's calls. In the
    profiled stretch each is also a ``record_function`` range, so the
    trace can say what the host was doing in a device gap; host-clock
    totals per name are kept in every stretch."""

    def __init__(self):
        self.profiling = False
        self.totals = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        if self.profiling:
            from torch.profiler import record_function
            with record_function(f"span:{name}"):
                yield
        else:
            yield
        dt = time.perf_counter() - t
        self.totals[name] = self.totals.get(name, 0.0) + dt

    def reset(self):
        self.totals = {}


# ------------------------------------------------------------------ window
def closed_loop(torch, job, seconds: float, sync: bool = True):
    """One client: ``job.iteration(k)`` back to back until ``seconds`` of
    host clock have passed, then a device synchronise.
    Returns {calls, units, seconds, latencies_s}: the rate is every unit
    over the whole window, the synchronise included."""
    lat, units, k = [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        units += job.iteration(k)
        te = time.perf_counter()
        lat.append(te - ts)
        k += 1
        if te - t0 >= seconds:
            break
    job.finish()
    if sync:
        torch.cuda.synchronize()
    return {"calls": k, "units": units,
            "seconds": time.perf_counter() - t0, "latencies_s": lat}


# ------------------------------------------------------------------- trace
class Trace:
    """What a per-layer reader reads: the profiled stretch's device events
    and host spans (profiler clock, us), the kernel inputs the rooflines
    captured, and the untraced stretch before it."""

    def __init__(self, events, spans, window_us, calls, captures, untraced,
                 flops_per_call):
        self.events = events          # [(name, start_us, end_us)] device
        self.spans = spans            # [(name, start_us, end_us)] host
        self.window_us = window_us    # (start, end)
        self.calls = calls
        self.captures = captures      # roofline name -> [input dicts]
        self.untraced = untraced      # closed_loop() of the untraced part
        self.flops_per_call = flops_per_call

    def busy_intervals(self):
        """Union of the device events' intervals, clipped to the window."""
        lo, hi = self.window_us
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.events
                    if e > lo and s < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_us(self):
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_us(self, names):
        return sum(e - s for n, s, e in self.events
                   if any(k in n for k in names))

    def kernels(self):
        return [ev for ev in self.events if not _is_copy(ev[0])]


def _is_copy(name: str) -> bool:
    n = name.lower()
    return n.startswith("memcpy") or n.startswith("memset")


def profile_stretch(torch, job, spans, calls: int, captures, host: bool):
    """Run ``calls`` iterations under torch.profiler with the roofline
    captures installed. ``host`` False records device activity alone (the
    least overhead: device time, launches, idle share), the stretch's
    length taken by the host clock between two synchronises; True records
    the host's ops and the harness's spans too, to say what the host was
    doing in each device gap. Returns (device events, host spans,
    window), in the profiler's microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    spans.profiling = host
    with captures, profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function("portbench:window"):
            for k in range(calls):
                job.iteration(k)
            job.finish()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans.profiling = False
    events, spans_out, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                events.append((e.name, tr.start, tr.end))
        elif e.name == "portbench:window":
            window = (tr.start, tr.end)
        elif e.name.startswith("span:"):
            spans_out.append((e.name[5:], tr.start, tr.end))
    if not events:
        raise BenchError("the profiler's trace holds no device events")
    if window is None:
        lo = min(s for _, s, _ in events)
        window = (lo, lo + wall_us)
    return events, spans_out, window


def breakdown(trace: Trace, host_trace: Trace, top: int = 10):
    """The device operations that took most time (``trace``), and the
    idle time of ``host_trace`` by the innermost host span open at each
    gap's middle."""
    by_op = {}
    for n, s, e in trace.events:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = {}, host_trace.window_us[0]
    for s, e in host_trace.busy_intervals() + [[host_trace.window_us[1]] * 2]:
        if s > prev:
            mid = 0.5 * (s + prev)
            open_ = [(hs, n) for n, hs, he in host_trace.spans
                     if hs <= mid <= he]
            label = max(open_)[1] if open_ else "outside any span"
            gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}


class Captures:
    """Wraps each roofline's op-level entry point for the profiled
    stretch: every call's inputs are kept (device tensors, no sync) for
    the roofline's operation and byte count."""

    def __init__(self, rooflines: dict):
        self.rooflines = rooflines        # name -> roofline module
        self.calls = {n: [] for n in rooflines}
        self._saved = []

    def __enter__(self):
        for name, rl in self.rooflines.items():
            mod = importlib.import_module(rl.ENTRY[0])
            fn = getattr(mod, rl.ENTRY[1])
            log = self.calls[name]

            def wrapped(*a, _fn=fn, _rl=rl, _log=log, **kw):
                out = _fn(*a, **kw)
                _log.append(_rl.capture(a, kw, out))
                return out

            self._saved.append((mod, rl.ENTRY[1], fn))
            setattr(mod, rl.ENTRY[1], wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []
        return False


# ------------------------------------------------------------------ verdict
def verdict(numbers: dict, limits: dict):
    """(correct, checks): every number compared beside its limit; a
    missing or non-finite number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: dict, checks: dict):
    """Print the checks as the last lines of stderr and the result as the
    last line of stdout, with the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
