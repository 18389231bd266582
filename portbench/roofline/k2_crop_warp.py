"""K2, the serving crops (``kernels/warp.py::affine_crop``): each crop
pixel a bilinear sample of its image at the inverse similarity. Bytes:
the crops written, and the image pixels under them read once each (the
distinct pixels nearest to the sample points, a lower bound on the taps
any interpolant reads), and the parameters."""

import torch

from portbench.harness import F32_PEAK

ENTRY = ("stlpose_tpu_torch.kernels.warp", "affine_crop")
KERNELS = ("affine_crop_kernel",)


def capture(args, kwargs, out):
    images, params, img_idx, size = args[:4]
    return {"shape": tuple(images.shape), "itemsize": images.element_size(),
            "params": params, "img_idx": img_idx, "size": tuple(size)}


def distinct_pixels(sx, sy, img, h, w):
    """Distinct in-bounds pixels nearest to the sample points."""
    nx, ny = torch.floor(sx + 0.5).long(), torch.floor(sy + 0.5).long()
    ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
    lin = (img * h + ny) * w + nx
    return int(torch.unique(lin[ok]).numel())


def work(inp):
    _, h, w, c = inp["shape"]
    dw, dh = inp["size"]
    p = inp["params"].float()
    k = p.shape[0]
    gy, gx = torch.meshgrid(
        torch.arange(dh, dtype=torch.float32, device=p.device),
        torch.arange(dw, dtype=torch.float32, device=p.device),
        indexing="ij")
    a, bb, tx, ty = (p[:, i, None, None] for i in range(4))
    img = inp["img_idx"].long()[:, None, None].expand(k, dh, dw)
    n = distinct_pixels(a * gx - bb * gy + tx, bb * gx + a * gy + ty, img,
                        h, w)
    nbytes = k * dh * dw * c * 4 + n * c * inp["itemsize"] + k * 20
    return 0.0, nbytes, F32_PEAK
