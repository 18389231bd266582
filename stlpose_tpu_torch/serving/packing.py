"""The packed wire format of the fused two-stage program: every output
flattened into one f32 buffer, so a serving host makes one device-to-host
copy a call. Port of ``stlpose_tpu/engines/vase_evaluator.py:
_fused_pack_spec``, ``_pack_fused_outputs`` and ``_unpack_fused_outputs``;
kept apart from the engines so that a loaded serving artifact unpacks its
buffer without importing any model code."""

from __future__ import annotations

import numpy as np
import torch


def _fused_pack_spec(B: int, m: int, budget: int, J: int = 17):
    """Static (key, shape, dtype) layout of the fused outputs when
    flattened into one f32 buffer (one device-to-host copy per call)."""
    return (("sel_boxes", (B, m, 4), np.float32),
            ("sel_scores", (B, m), np.float32),
            ("sel_valid", (B, m), np.bool_),
            ("img_idx", (budget,), np.int32),
            ("picked_valid", (budget,), np.bool_),
            ("crop_kpts", (budget, J, 3), np.float32),
            ("img_kpts", (budget, J, 3), np.float32))


def _pack_fused_outputs(out, spec):
    """Flatten + cast every output to f32 and concatenate (bool -> {0,1};
    int32 image indices are exact in f32)."""
    return torch.cat([out[k].to(torch.float32).reshape(-1)
                      for k, _, _ in spec])


def _unpack_fused_outputs(buf: np.ndarray, spec):
    """Host inverse of :func:`_pack_fused_outputs`; a layout mismatch
    fails loudly instead of mis-splitting."""
    total = sum(int(np.prod(shape)) for _, shape, _ in spec)
    if buf.size != total:
        raise ValueError(
            f"packed buffer has {buf.size} elements but the spec "
            f"describes {total} — pack/spec layout mismatch")
    out, off = {}, 0
    for k, shape, dt in spec:
        n = int(np.prod(shape))
        v = buf[off:off + n].reshape(shape)
        off += n
        if dt == np.bool_:
            v = v > 0.5
        elif dt == np.int32:
            v = np.rint(v).astype(np.int32)
        out[k] = v
    return out
