"""K5, greedy NMS (``kernels/nms.py::box_nms_topk``). What these inputs
need: every candidate's box, score and validity read once and its keep
flag written once. Its picks are sequential, so it sits far from this
bound; the share says how far."""

from portbench.harness import F32_PEAK

ENTRY = ("stlpose_tpu_torch.kernels.nms", "box_nms_topk")
KERNELS = ("nms_sort_kernel", "nms_sort_global_kernel", "nms_mask_kernel",
           "nms_scan_kernel")


def capture(args, kwargs, out):
    scores = args[1]
    return {"shape": tuple(scores.shape)}


def work(inp):
    b, m = inp["shape"]
    return 0.0, b * m * (16 + 4 + 1 + 1), F32_PEAK
