"""Run one cell of the benchmark of stlpose_tpu_torch on this machine's
first NVIDIA GPU.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the program's kernels built or loaded, weights and inputs made on
the device from the seed, the cell's shapes warmed up) is followed by a
closed-loop window of ``--seconds``. With ``--trace 0`` the result line
holds the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read from the same window (rates, waits) and from a short
profiled stretch after it with device activity alone (device time,
launches, rooflines, idle share); three more calls profiled with the
host's ops say what the host did in each device gap. Then the program's
state is freed and the plain reference recomputes a sample of what the
window produced: the numbers compared and their limits are the last
lines of stderr and the last key of the result, the last line of
stdout. Without a CUDA device the run exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import sys

PROFILED_S = 1.5            # length of the profiled stretch of a traced run
HOST_PROFILED_CALLS = 3     # calls profiled with the host's ops, for labels


class Context:
    """What a driver is given: the run's arguments, the cell's files, the
    device and the host spans."""

    def __init__(self, args, cell, device, spans):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = args.trace
        self.name = cell["name"]
        self.workload = cell["workload"]
        self.config = cell["config"]
        self.device = device
        self.spans = spans


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(args, device=None):
    """(harness, manifest, cell, torch, device): the cell's files found by
    name, the card checked (``device`` given: that device, for tests),
    the configuration's float32 arithmetic set."""
    from portbench import harness as H
    man = H.manifest()
    entry = next((w for w in man["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        raise H.BenchError(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = H.load_cell(args.workload)
    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < entry["chips"]):
            raise H.BenchError(f"cell {args.workload} needs "
                               f"{entry['chips']} CUDA device(s); found "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    tf32 = bool(cell["config"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return H, man, cell, torch, torch.device(device)


def run(argv, device=None) -> int:
    args = parse(argv)
    try:
        H, man, cell, torch, dev = prepare(args, device)
    except Exception as e:           # no card, no cell: no result
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    on_card = dev.type == "cuda"
    spans = H.Spans()
    job = cell["driver"].setup(Context(args, cell, dev, spans))
    if on_card:
        torch.cuda.synchronize()
    setup_s = H.process_age_s()
    spans.reset()
    win = H.closed_loop(torch, job, args.seconds, sync=on_card)
    span = getattr(cell["driver"], "INPUT_SPAN", None)
    win["input_wait_s"] = spans.totals.get(span) if span else None
    values = dict(job.end_to_end(win), setup_s=setup_s)
    e2e, layers = H.cell_metrics(man, args.workload, set(values))
    units = {m["name"]: m["unit"] for m in man["end_to_end"] +
             man["per_layer"]}
    device = {"platform": "gpu" if on_card else dev.type,
              "kind": None, "count": 1, "memory_peak_bytes": None}
    if on_card:
        device["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        device["kind"], device["power_limit_w"] = H.card_info(torch)
    result = {}
    if args.trace:
        if not on_card:
            print("portbench: --trace 1 reads the card's profiler",
                  file=sys.stderr)
            return 2
        readers = {m["name"]: H.load_module("metrics", m["name"]).read
                   for m in layers}
        caps = H.Captures({r.ROOFLINE: H.load_module("roofline", r.ROOFLINE)
                           for r in readers.values()
                           if hasattr(r, "ROOFLINE")})
        job.keep = False
        per_call = win["seconds"] / win["calls"]
        calls = max(3, min(30, round(PROFILED_S / per_call)))
        events, _, window = H.profile_stretch(torch, job, spans, calls, caps,
                                              host=False)
        trace = H.Trace(events, [], window, calls, caps.calls, win,
                        job.flops_per_call)
        host_trace = H.Trace(*H.profile_stretch(
            torch, job, spans, HOST_PROFILED_CALLS, H.Captures({}),
            host=True), HOST_PROFILED_CALLS, {}, win, job.flops_per_call)
        metrics = {}
        for name, read in readers.items():
            v = read(trace)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        device["busy_s"] = trace.busy_us() * 1e-6
        device["window_s"] = (window[1] - window[0]) * 1e-6
        result["breakdown"] = H.breakdown(trace, host_trace)
        del trace, host_trace, caps
    else:
        metrics = {n: {"value": values[n], "unit": units[n]} for n in e2e}
    job.release()
    limits = cell["workload"]["limits"]
    samples = job.judge_outputs(job.program_outputs(win))
    numbers = {k: max(s[k] for s in samples) for k in limits}
    failed = sum(1 for s in samples if not H.verdict(s, limits)[0])
    correct, checks = H.verdict(numbers, limits)
    bad = H.forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX package or of JAX were "
              f"loaded: {bad}", file=sys.stderr)
        return 3
    H.emit({"correct": correct, "attempted": win["calls"], "failed": failed,
            "metrics": metrics, "device": device, **result}, checks)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
