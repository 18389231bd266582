"""PyTorch/CUDA port of stlpose_tpu for NVIDIA Hopper (H100, sm_90a).

The JAX package ``stlpose_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. The slice ported so far
is the fused two-stage serving path
(``engines.vase_evaluator.build_fused_two_stage``): Faster R-CNN
ResNet50-FPN -> score filter -> cross-batch crop compaction -> affine
crops -> HRNet-W32 -> heatmap decode. Its three TPU kernels are CUDA C++
kernels under ``kernels/csrc`` (built with nvcc at first use).

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; with "cuda" and no GPU it raises. On CPU tensors
each kernel wrapper runs its plain PyTorch version; a CUDA tensor always
reaches the kernel.
"""

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument; raises
    when CUDA is asked for and no GPU is present (no silent CPU run)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device
