"""What the drivers share about the program under test
(``stlpose_tpu_torch``): its configuration objects built from a
``portbench/configs`` file, and the seeded weights the benchmark gives
both the program and the reference."""

from __future__ import annotations

import dataclasses


def hrnet_config(pcfg: dict):
    from stlpose_tpu_torch.config import HRNetConfig, HRNetStageConfig
    st = [HRNetStageConfig(s["num_modules"], s["num_branches"],
                           tuple(s["num_blocks"]), tuple(s["num_channels"]))
          for s in pcfg["stages"]]
    return HRNetConfig(num_joints=pcfg["num_joints"],
                       final_conv_kernel=pcfg["final_conv_kernel"],
                       stem_channels=pcfg["stem_channels"],
                       stage1_num_blocks=pcfg["stage1_num_blocks"],
                       stage2=st[0], stage3=st[1], stage4=st[2])


def frcnn_config(dcfg: dict):
    from stlpose_tpu_torch.config import FasterRCNNConfig
    kw = {}
    for f in dataclasses.fields(FasterRCNNConfig):
        v = dcfg[f.name]
        kw[f.name] = tuple(v) if isinstance(v, list) else v
    return FasterRCNNConfig(**kw)


def seeded_state(torch, model, seed: int, device) -> dict:
    """A state dict for ``model``'s layout made on ``device`` from
    ``seed`` in two draws: convolution and dense kernels normal over the
    square root of their fan-in, other biases 0.1 x normal, BatchNorm at
    its identity (scale 1, shift 0, running mean 0, running variance 1),
    so activations stay finite through both deep networks."""
    bn = set()
    for mname, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            bn.add(mname)
    sd = model.state_dict()
    g = torch.Generator(device=device).manual_seed(seed)
    kernels = [k for k, v in sd.items() if v.dim() > 1]
    biases = [k for k, v in sd.items() if v.dim() == 1 and
              k.rsplit(".", 1)[0] not in bn]
    out = {}
    for names, scale in ((kernels, None), (biases, 0.1)):
        flat = torch.randn(sum(sd[k].numel() for k in names), generator=g,
                           device=device)
        off = 0
        for k in names:
            n = sd[k].numel()
            t = flat[off:off + n].view(sd[k].shape)
            fan_in = sd[k][0].numel()
            out[k] = t * (scale if scale is not None else fan_in ** -0.5)
            off += n
    for k, v in sd.items():
        if k in out:
            continue
        owner, leaf = k.rsplit(".", 1)
        if owner not in bn:
            raise ValueError(f"no seeded value for {k}")
        fill = {"weight": 1.0, "running_var": 1.0}.get(leaf, 0.0)
        out[k] = torch.full(v.shape, fill, dtype=v.dtype, device=device)
    return out
