"""K1, the heatmap peaks (``kernels/decode.py``): every map value read
once; per map the argmax (x, y), the maximum and the quarter-pixel shift
(x, y) written. No arithmetic worth a peak: bound by bytes."""

from portbench.harness import F32_PEAK

ENTRY = ("stlpose_tpu_torch.kernels.decode", "heatmap_peaks")
KERNELS = ("peaks_bulk_kernel", "peaks_strided_kernel")


def capture(args, kwargs, out):
    hm = args[0]
    return {"shape": tuple(hm.shape), "itemsize": hm.element_size()}


def work(inp):
    n, j, h, w = inp["shape"]
    return 0.0, n * j * h * w * inp["itemsize"] + n * j * 5 * 4, F32_PEAK
