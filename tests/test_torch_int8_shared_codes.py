"""Shared K6q codes in the int8 HRNet and ResNet trunk
(``stlpose_tpu_torch/models/hrnet.py::shared_codes``).

Where several int8 ConvBNs read one tensor with equal (quant, sx, zp,
qlo, qhi) -- a bottleneck's ``cb1`` and ``down``, HRNet's fuse layers on
one branch output, the stage-2 transitions -- the tensor is quantized once
and the codes go to each. The codes are the same bits either way, so the
forward must equal, bit for bit, the forward in which every ConvBN
quantizes its own input. Both run on the CPU, on the kernels' plain
versions (``kernels/int8_conv.py``); no JAX model runs here (the int8
models' JAX parity is in ``tests/test_torch_int8_models.py``)."""

import numpy as np
import pytest
import torch

from stlpose_tpu_torch.config import FASTER_RCNN_TINY, HRNET_TINY
from stlpose_tpu_torch.kernels import int8_conv as k6
from stlpose_tpu_torch.models import hrnet
from stlpose_tpu_torch.models.convert import load_strict
from stlpose_tpu_torch.models.faster_rcnn import FasterRCNN
from stlpose_tpu_torch.models.hrnet import (ConvBN, PoseHighResolutionNet,
                                            int8_quantizations, shared_codes)
from stlpose_tpu_torch.models.quantize import (flavored_state_dict,
                                               quantize_hrnet_from_batches)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

QUANTS = {"int8": "signed", "int8u": "unsigned"}
# ConvBNs and K6q launches of one forward: HRNET_TINY saves one in
# layer1_0 (cb1, down), one in the stage-2 transitions and three in stage
# 3's fuse layers (stage 4's one module outputs one branch); the tiny
# trunk one in each of its four first blocks
COUNTS = {"hrnet": (40, 35), "trunk": (16, 12)}


def _seeded(module, seed):
    """Every parameter and BatchNorm statistic of ``module`` redrawn from
    a seeded numpy stream (non-trivial BatchNorm, so folding matters)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            v = rng.randn(*t.shape).astype(np.float32)
            if name.endswith("running_var"):
                v = np.abs(v) * 0.5 + 0.5
            elif name.endswith(("bn.weight", "stem_bn.weight")):
                v = v * 0.2 + 1.0
            elif v.ndim == 4:
                v = v * np.sqrt(2.0 / np.prod(v.shape[1:]))
            else:
                v = v * 0.1
            t.copy_(torch.from_numpy(v))
    return module


@pytest.fixture(scope="module", params=["hrnet", "trunk"])
def net(request):
    """{quant: (int8 model, its state dict)} and an input, for HRNET_TINY
    (normalized crops) or FASTER_RCNN_TINY's trunk (0-1 images, NCHW)."""
    rng = np.random.RandomState(7)
    if request.param == "hrnet":
        live = _seeded(PoseHighResolutionNet(HRNET_TINY, device="cpu"), 1)
        sd = {k: v for k, v in live.state_dict().items()
              if not k.endswith("num_batches_tracked")}
        calib = torch.from_numpy(rng.randn(2, 256, 192, 3).astype(
            np.float32))
        x = torch.from_numpy(rng.randn(2, 256, 192, 3).astype(np.float32))
        models = {}
        for quant, scheme in QUANTS.items():
            qsd, model = quantize_hrnet_from_batches(
                "tiny", sd, [calib], device="cpu", act_scheme=scheme)
            models[quant] = (model, qsd)
        return request.param, models, x
    live = _seeded(FasterRCNN(FASTER_RCNN_TINY, device="cpu"), 2)
    sd = {k: v for k, v in live.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    S = FASTER_RCNN_TINY.image_size
    calib = rng.rand(2, S, S, 3).astype(np.float32)
    x = torch.from_numpy(rng.rand(2, 3, S, S).astype(np.float32))
    models = {}
    for quant in QUANTS:
        qsd = flavored_state_dict(sd, quant, config=FASTER_RCNN_TINY,
                                  calib_batches=[calib])
        det = load_strict(FasterRCNN(FASTER_RCNN_TINY, device="cpu",
                                     trunk_quant=quant), qsd)
        bb = {k[len("backbone."):]: v for k, v in qsd.items()
              if k.startswith("backbone.")}
        models[quant] = (det.backbone, bb)
    return request.param, models, x


def _forward(model, x):
    with torch.inference_mode():
        out = model(x)
    return out if isinstance(out, torch.Tensor) else torch.cat(
        [o.flatten() for o in out])


def _unshared(model, x, monkeypatch):
    """The forward with every ConvBN quantizing its own input."""
    with monkeypatch.context() as m:
        m.setattr(hrnet, "shared_codes", lambda x, cbs: [None] * len(cbs))
        return _forward(model, x)


def _counted(model, x, monkeypatch):
    """(output, K6q calls, K6 calls) of one forward."""
    calls = {"q": 0, "c": 0}
    q_fn, c_fn = k6.quantize_activations, k6.int8_conv

    def q(*a, **kw):
        calls["q"] += 1
        return q_fn(*a, **kw)

    def c(*a, **kw):
        calls["c"] += 1
        return c_fn(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(k6, "quantize_activations", q)
        m.setattr(k6, "int8_conv", c)
        out = _forward(model, x)
    return out, calls["q"], calls["c"]


@pytest.mark.parametrize("quant", list(QUANTS))
def test_shared_codes_equal_own_quantization(net, quant, monkeypatch):
    """The shared-code forward equals, bit for bit, the forward in which
    every ConvBN quantizes its own input; and each int8 ConvBN's output in
    it equals that ConvBN called by itself on its input."""
    _, models, x = net
    model, _ = models[quant]
    seen = []

    def own(mod, inp, out):
        seen.append(torch.equal(out, mod.forward(inp[0])))

    hooks = [m.register_forward_hook(own) for m in model.modules()
             if isinstance(m, ConvBN) and m.share_key is not None]
    try:
        got = _forward(model, x)
    finally:
        for h in hooks:
            h.remove()
    ref = _unshared(model, x, monkeypatch)
    assert torch.equal(got, ref)
    assert len(seen) == len(hooks) and all(seen)


@pytest.mark.parametrize("quant", list(QUANTS))
def test_quantize_launches_are_distinct_count(net, quant, monkeypatch):
    """K6q runs once per distinct (input, scales) in a forward, as many
    times as ``int8_quantizations`` counts on the model; K6 once per int8
    ConvBN."""
    name, models, x = net
    model, _ = models[quant]
    _, n_q, n_c = _counted(model, x, monkeypatch)
    assert (n_c, n_q) == COUNTS[name]
    assert n_q == int8_quantizations(model)


PLANTED = "layer1_0"      # the first bottleneck: cb1 and down share


def test_planted_scale_is_not_shared(net, monkeypatch):
    """A consumer whose ``sx`` differs from its neighbour's quantizes its
    own input: one K6q more, and the output still equals the unshared
    forward's. The equality cache follows ``load_state_dict``: the planted
    scale splits the group, the original state dict joins it again."""
    name, models, x = net
    model, sd = models["int8u"]
    block = model.get_submodule(PLANTED)
    assert block.cb1.share_key == block.down.share_key
    planted = dict(sd)
    planted[f"{PLANTED}.down.sx"] = sd[f"{PLANTED}.down.sx"] * 1.25
    try:
        load_strict(model, planted)
        assert block.cb1.share_key != block.down.share_key
        assert block.down.share_key[:2] == ("int8u", float(
            planted[f"{PLANTED}.down.sx"]))
        assert shared_codes(x, [block.cb1, block.down]) == [None, None]
        got, n_q, _ = _counted(model, x, monkeypatch)
        assert n_q == COUNTS[name][1] + 1 == int8_quantizations(model)
        assert torch.equal(got, _unshared(model, x, monkeypatch))
    finally:
        load_strict(model, sd)
    assert block.cb1.share_key == block.down.share_key
    assert int8_quantizations(model) == COUNTS[name][1]


def test_float_and_calib_modes_share_nothing():
    """Float and "calib" ConvBNs have no share key: ``shared_codes`` hands
    them None and they run as before."""
    x = torch.randn(1, 16, 8, 8)
    cbs = [ConvBN(16, 16, 1, folded=True), None,
           ConvBN(16, 32, 3, folded=True, quant="calib"),
           ConvBN(16, 8, 1, folded=True, quant="calib")]
    assert [cb.share_key for cb in cbs if cb is not None] == [None] * 3
    assert shared_codes(x, cbs) == [None] * 4
    a = ConvBN(16, 16, 1, folded=True, quant="int8")
    b = ConvBN(16, 8, 3, 2, folded=True, quant="int8")
    qa, qb = shared_codes(x, [a, b])
    assert qa is qb and torch.equal(qa, a.quantize(x))
