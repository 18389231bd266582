"""Faults planted under the timed path, for the checks that the comparison
deciding ``correct`` fails when the program is wrong (the tests, and the
readings of a training cell's faults). Each is a context manager that
patches the program and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, attr, make):
    old = getattr(module, attr)
    setattr(module, attr, make(old))
    try:
        yield
    finally:
        setattr(module, attr, old)


def altered_peak():
    """K1 reports, for the map with the widest range of each call, the
    place and value of its minimum as its peak."""
    from stlpose_tpu_torch.kernels import decode

    def make(fn):
        def peaks(hm):
            coords, maxvals, shift = fn(hm)
            n, j, h, w = hm.shape
            flat = hm.reshape(n * j, h * w)
            k = int((flat.amax(1) - flat.amin(1)).argmax())
            low = int(flat[k].argmin())
            coords, maxvals = coords.clone(), maxvals.clone()
            coords.view(n * j, 2)[k] = coords.new_tensor(
                [low % w, low // w])
            maxvals.view(n * j)[k] = flat[k, low]
            return coords, maxvals, shift
        return peaks
    return _patched(decode, "heatmap_peaks", make)


def serve_half_batch():
    """The engine answers for the first half of each batch only."""
    import numpy as np
    from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator

    def make(fn):
        def unpack(self, out, spec):
            res = fn(self, out, spec)
            for r in res[len(res) // 2:]:
                for k, v in r.items():
                    r[k] = np.zeros((0,) + v.shape[1:], v.dtype)
            return res
        return unpack
    return _patched(VaseEvaluator, "_unpack", make)


def serve_repeat():
    """The engine repeats one detection: in the first image with two or
    more, the first detection (box, score and crop) comes twice and the
    last is lost, as a compaction or gather that reads one slot twice."""
    import numpy as np
    from stlpose_tpu_torch.engines.vase_evaluator import VaseEvaluator

    def make(fn):
        def unpack(self, out, spec):
            res = fn(self, out, spec)
            for r in res:
                if len(r["boxes"]) >= 2:
                    for k, v in r.items():
                        if len(v) >= 2:
                            r[k] = np.concatenate([v[:1], v[:-1]])
                    break
            return res
        return unpack
    return _patched(VaseEvaluator, "_unpack", make)


def extract_half_batch():
    """Peaks computed for the first half of each batch, copied over the
    second half."""
    import torch
    from stlpose_tpu_torch.engines.retrieval_db import ArchDataExtractor

    def make(fn):
        def batch_peaks(self, images, n):
            h = images.shape[0] // 2
            peaks, hw = fn(self, images[:h], h)
            return torch.cat([peaks, peaks[:n - h]]), hw
        return batch_peaks
    return _patched(ArchDataExtractor, "batch_peaks", make)


def train_unchanged():
    """The optimizer's step leaves the state as it was."""
    import torch
    return _patched(torch.optim.Adam, "step",
                    lambda fn: lambda self, closure=None: None)


def train_half_batch():
    """The step trains on the first half of its batch, the mean taken
    over it."""
    from stlpose_tpu_torch.parallel import steps

    def make(fn):
        def make_train_step(*a, **kw):
            step = fn(*a, **kw)

            def half(state, batch):
                n = batch["image"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
            return half
        return make_train_step
    return _patched(steps, "make_train_step", make)


def train_altered_loss():
    """The loss the step differentiates is off by a thousandth."""
    from stlpose_tpu_torch.parallel import steps
    return _patched(steps, "person_mse_loss",
                    lambda fn: lambda *a, **kw: fn(*a, **kw) * 1.001)


FAULTS = {"serve_fused": {"half_batch": serve_half_batch,
                          "repeat": serve_repeat,
                          "altered_peak": altered_peak},
          "extract_flip": {"half_batch": extract_half_batch,
                           "altered_peak": altered_peak},
          "train_step": {"unchanged": train_unchanged,
                         "half_batch": train_half_batch,
                         "altered_loss": train_altered_loss}}
