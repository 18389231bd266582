"""Plain reference of the pose training job's first steps: HRNet's
augmentation draw (half body, scale, rotation, flip; the published
``w32_256x192_adam_lr1e-3`` recipe), the letterboxed canvas, the two-pass
rotated crop, the Gaussian targets, the train-mode forward, the masked
MSE with the styled-COCO perceptual weighting ``loss * (1 + mean(perc))``,
autograd's gradient and Adam (betas 0.9 / 0.999, eps 1e-8 outside the
root of the bias-corrected second moment).

The draw consumes one ``numpy.random.RandomState`` record by record in
the order the pipeline serves them, as HRNet's ``JointsDataset`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import models, ops

UPPER_BODY_IDS = frozenset(range(11))
CROP_W, CROP_H = 192, 256
ASPECT = CROP_W / CROP_H


class Draws:
    """HRNet's train-time augmentation sampler."""

    def __init__(self, seed, scale_factor, rot_factor, flip,
                 num_joints_half_body, prob_half_body):
        self.rng = np.random.RandomState(seed)
        self.sf, self.rf = float(scale_factor), float(rot_factor)
        self.flip = bool(flip)
        self.nhb, self.phb = num_joints_half_body, float(prob_half_body)

    def _half_body(self, joints, vis):
        upper = [joints[j] for j in range(len(joints))
                 if vis[j] > 0 and j in UPPER_BODY_IDS]
        lower = [joints[j] for j in range(len(joints))
                 if vis[j] > 0 and j not in UPPER_BODY_IDS]
        sel = upper if (self.rng.randn() < 0.5 and len(upper) > 2) else lower
        if len(sel) < 2:
            return None, None
        sel = np.asarray(sel, np.float32)
        center = sel.mean(axis=0)
        lt, rb = sel.min(axis=0), sel.max(axis=0)
        w, h = rb[0] - lt[0], rb[1] - lt[1]
        if w > ASPECT * h:
            h = w / ASPECT
        elif w < ASPECT * h:
            w = h * ASPECT
        return center, np.array([w / ops.PIXEL_STD, h / ops.PIXEL_STD],
                                np.float32) * 1.5

    def sample(self, center, scale, joints, vis):
        c, s, r = center.copy(), scale.copy(), 0.0
        if vis.sum() > self.nhb and self.rng.rand() < self.phb:
            ch, sh = self._half_body(joints, vis)
            if ch is not None:
                c, s = ch, sh
        s = s * np.clip(self.rng.randn() * self.sf + 1, 1 - self.sf,
                        1 + self.sf)
        if self.rng.rand() <= 0.6 and self.rf > 0:
            r = float(np.clip(self.rng.randn() * self.rf, -self.rf * 2,
                              self.rf * 2))
        return c, s, r, bool(self.flip and self.rng.rand() <= 0.5)


def batches(records, draws, n_batches, batch, device, order=None):
    """The first ``n_batches`` training batches: for each, (crops
    normalised (N, 256, 192, 3), targets (N, J, 64, 48), weights (N, J),
    perceptual losses (N,)). ``records``: dict of numpy arrays, images
    (M, S, S, 3) uint8 square canvases, centers, scales, joints, vis,
    perceptual. ``order``: the records in the order they drew their
    augmentation (several decode threads take the sampler in turn), by
    default the records' own order."""
    out = []
    perm = ops.flip_perm(records["joints"].shape[1])
    n = n_batches * batch
    drawn = {}
    for i in (order if order is not None else range(n))[:n]:
        drawn[i] = draws.sample(records["centers"][i].copy(),
                                records["scales"][i].copy(),
                                records["joints"][i].copy(),
                                records["vis"][i].copy())
    for b in range(n_batches):
        rows = range(b * batch, (b + 1) * batch)
        imgs, cs, ss, rs, js, vs = [], [], [], [], [], []
        for i in rows:
            img = records["images"][i]
            joints = records["joints"][i].copy()
            vis = records["vis"][i].copy()
            c, s, r, flip = drawn[i]
            if flip:
                img = img[:, ::-1]
                joints[:, 0] = img.shape[1] - joints[:, 0] - 1
                joints = joints[perm] * vis[perm][:, None]
                vis = vis[perm]
                c = c.copy()
                c[0] = img.shape[1] - c[0] - 1
            imgs.append(np.ascontiguousarray(img))
            cs.append(c)
            ss.append(s)
            rs.append(r)
            js.append(joints)
            vs.append(vis)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        canv = dev(np.stack(imgs), torch.uint8)
        c, s, r = dev(np.stack(cs)), dev(np.stack(ss)), dev(np.asarray(rs))
        j, v = dev(np.stack(js)), dev(np.stack(vs))
        crops = ops.two_pass_crops(canv, c, s, r, CROP_W, CROP_H)
        jc = ops.apply_matrix(j, ops.forward_matrix(c, s, r, CROP_W, CROP_H))
        jc = torch.where(v[..., None] > 0, jc, j)
        target, weight = ops.gaussian_targets(jc, v)
        out.append((ops.normalise(crops), target, weight,
                    dev(records["perceptual"][list(rows)])))
    return out


def steps(W, pcfg, param_names, data, lr, betas=(0.9, 0.999), eps=1e-8):
    """Adam steps from the weights ``W`` on the batches ``data``. Returns
    (losses, first gradient by leaf, each leaf's change after the last
    step): norms as host floats, by parameter name."""
    params = {n: W[n].detach().clone().requires_grad_(True)
              for n in param_names}
    state = {n: (torch.zeros_like(p), torch.zeros_like(p))
             for n, p in params.items()}
    b1, b2 = betas
    losses, first = [], None
    for t, (x, target, weight, perc) in enumerate(data, start=1):
        hm = models.hrnet({**W, **params}, pcfg, x, train=True)
        loss = ops.pose_mse(hm, target, weight)
        loss = loss + loss * perc.mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {n: float(g.norm()) for n, g in zip(params, grads)}
            for (n, p), g in zip(params.items(), grads):
                m, v = state[n]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
    change = {n: float((p.detach() - W[n]).norm()) for n, p in params.items()}
    return losses, first, change
