"""CUDA kernels of the port (csrc/*.cu), each beside its plain PyTorch
version and a launch counter.

Importing this package registers the serving kernels as the ``stlpose``
operators (``_ops.py``): K1 ``heatmap_peaks``, K2 ``affine_crop``, K3
``roi_align``, K3q ``quantize_levels``, K5 ``box_nms_topk``, K6
``int8_conv`` and K6q ``quantize_activations``. Nothing is built at
import: ``_build`` compiles a kernel at its first launch."""

from stlpose_tpu_torch.kernels import (decode, int8_conv, nms, quantize,
                                       roi_align, warp)

__all__ = ["decode", "int8_conv", "nms", "quantize", "roi_align", "warp"]
