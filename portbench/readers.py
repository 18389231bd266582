"""The reductions behind the per-layer metrics. Each metric file under
``portbench/metrics/`` binds one of them; each returns None where its
trace holds nothing to read, and the metric is then left out."""

from __future__ import annotations

from portbench import harness as H


def device_idle(trace):
    """% of the profiled stretch in which no operation ran on the card."""
    lo, hi = trace.window_us
    return 100.0 * (1.0 - trace.busy_us() / (hi - lo))


def mfu(trace):
    """% of the card's float32 peak: the model's FLOPs a call times the
    calls over the seconds of the untraced stretch."""
    u = trace.untraced
    if not trace.flops_per_call or not u["seconds"]:
        return None
    return (100.0 * trace.flops_per_call * u["calls"] / u["seconds"] /
            H.F32_PEAK)


def launches_per_call(trace):
    """Device kernels launched a call in the profiled stretch."""
    return len(trace.kernels()) / trace.calls


def input_wait_ms(trace):
    """Host-clock ms a call spent asking the input pipeline for its next
    batch, over the untraced stretch."""
    u = trace.untraced
    if u.get("input_wait_s") is None:
        return None
    return 1e3 * u["input_wait_s"] / u["calls"]


def roofline(name):
    """A reader of kernel ``name``'s share of its roofline: the least time
    its captured calls' work needs on the card (bytes at the HBM rate or
    operations at their peak, whichever is longer) over the device time
    of its kernels in the same stretch."""
    rl = H.load_module("roofline", name)

    def read(trace):
        calls = trace.captures.get(name) or []
        dev_us = trace.kernel_us(rl.KERNELS)
        if not calls or dev_us <= 0:
            return None
        least = 0.0
        for inp in calls:
            flops, nbytes, peak = rl.work(inp)
            least += max(nbytes / H.HBM_BYTES_PER_S, flops / peak)
        return 100.0 * least / (dev_us * 1e-6)

    read.ROOFLINE = name
    return read
