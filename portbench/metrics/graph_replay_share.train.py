"""% of the device-only stretch's training steps (span train.step) that
replayed a CUDA graph (a span train.replay in the same top-level call;
moves train_samples_per_s). None where the program has no graph path or
the recorder holds no step."""

from portbench import recorder


def read(trace):
    from stlpose_tpu_torch.parallel import steps
    if not hasattr(steps, "graph_route"):
        return None
    snap = recorder.store()
    if not snap:
        return None
    calls = recorder._calls(snap, "train.step", trace.calls)
    if not calls:
        return None
    replayed = {s["call"] for s in snap["spans"]
                if s["name"] == "train.replay"}
    return 100.0 * sum(c in replayed for c in calls) / len(calls)
