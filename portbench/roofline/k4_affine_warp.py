"""K4, the device-warp crops (``kernels/warp_two_pass.py``): the two-pass
filter of the (rotated) training and extraction crops from uint8
canvases. Bytes: the f32 crops written, the distinct canvas pixels
nearest to the crops' source points read once each, the parameters."""

import torch

from portbench.harness import F32_PEAK
from portbench.roofline.k2_crop_warp import distinct_pixels

ENTRY = ("stlpose_tpu_torch.kernels.warp_two_pass", "warp_two_pass")
KERNELS = ("warp_two_pass_kernel",)


def capture(args, kwargs, out):
    images, params, size = args[:3]
    return {"shape": tuple(images.shape), "itemsize": images.element_size(),
            "params": params, "size": tuple(size)}


def work(inp):
    n, s, _, c = inp["shape"]
    dw, dh = inp["size"]
    p = inp["params"].float()
    gy, gx = torch.meshgrid(
        torch.arange(dh, dtype=torch.float32, device=p.device),
        torch.arange(dw, dtype=torch.float32, device=p.device),
        indexing="ij")
    # rows (u, r, txr, b, a, ty, swap, 0) of the map in the (possibly
    # turned) canvas: y = b x' + a y' + ty, x = u x' - r y + txr
    u, r, txr, b, a, ty = (p[:, i, None, None] for i in range(6))
    sy = b * gx + a * gy + ty
    sx = u * gx - r * sy + txr
    img = torch.arange(n, device=p.device)[:, None, None].expand(n, dh, dw)
    k = distinct_pixels(sx, sy, img, s, s)
    nbytes = n * dh * dw * c * 4 + k * c * inp["itemsize"] + n * 32
    return 0.0, nbytes, F32_PEAK
