"""AdaIN style transfer: the stylizer, its decoder and the decoder trainer.

Port of ``stlpose_tpu/models/adain.py``:

    t = AdaIN(enc(content), enc(style))
    out = dec(alpha * t + (1 - alpha) * enc(content))

The encoder is the VGG16 trunk to relu3_3 (``models/vgg.py``), frozen;
the decoder mirrors it with nearest 2x upsampling. ``AdaINStylizer``
stylizes a batch of crops inside the pose and detection pipelines
(``dataset.inline_style``, wired by ``build_inline_stylizer``) and makes
Styled-COCO offline (``scripts/aux_styled_coco_preload.py``);
``train_adain_decoder`` trains the decoder with the standard AdaIN content
and style losses (``scripts/aux_train_adain_decoder.py``).

NHWC at the boundary, NCHW inside. A trained decoder is kept in the JAX
package's file format, an npz whose ``params`` entry is the Flax
parameter dict (``dec0``..``dec5``, each an HWIO ``kernel`` and a
``bias``): ``load_decoder_npz`` and ``save_decoder_npz``, so a decoder
trained by either package loads in the other. ``cv2`` is imported only
inside ``read_style_bank``: the card's machine has none.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from stlpose_tpu_torch.models.vgg import (VGG16Features, imagenet_normalise,
                                          init_convs, vgg16_from_torchvision)


def adain(content_feat, style_feat, eps: float = 1e-5):
    """Adaptive instance normalisation of NCHW features: the content's
    per-channel mean and population standard deviation over H and W (eps
    inside the square root) replaced by the style's."""
    dims = (2, 3)
    c_mean = content_feat.mean(dim=dims, keepdim=True)
    c_std = torch.sqrt(content_feat.var(dim=dims, keepdim=True,
                                        correction=0) + eps)
    s_mean = style_feat.mean(dim=dims, keepdim=True)
    s_std = torch.sqrt(style_feat.var(dim=dims, keepdim=True,
                                      correction=0) + eps)
    return s_std * (content_feat - c_mean) / c_std + s_mean


class AdaINDecoder(nn.Module):
    """Mirror of the VGG trunk up to relu3_3: 256 -> 128 -> 64 -> 3, with
    nearest 2x upsampling before ``dec1`` and ``dec3``."""

    _CHANNELS = ((256, 256), (256, 128), (128, 128), (128, 64), (64, 64),
                 (64, 3))

    def __init__(self, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        for i, (cin, cout) in enumerate(self._CHANNELS):
            self.add_module(f"dec{i}", nn.Conv2d(cin, cout, 3, padding=1))
        init_convs(self, generator)
        self.to(resolve_device(device))

    def decode(self, x):
        """NCHW relu3_3 features -> NCHW images (ImageNet-normalised)."""
        x = F.relu(self.dec0(x))
        x = F.relu(self.dec1(F.interpolate(x, scale_factor=2,
                                           mode="nearest")))
        x = F.relu(self.dec2(x))
        x = F.relu(self.dec3(F.interpolate(x, scale_factor=2,
                                           mode="nearest")))
        x = F.relu(self.dec4(x))
        return self.dec5(x)

    def forward(self, x):
        """NHWC in, NHWC out."""
        return self.decode(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _denormalise(x):
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return x * std + mean


class AdaINStylizer:
    """Batched stylization on ``device``.

    Args:
      encoder: ``VGG16Features`` with taps ``ENC_TAPS`` (pretrained, or
        fixed random features); seeded Flax-style init from ``generator``
        when None.
      decoder: ``AdaINDecoder``; likewise when None.
      generator: CPU ``torch.Generator`` of the default inits (seed 0 when
        None); the encoder draws first, then the decoder.
    """

    # relu1_2, relu2_2, relu3_3: the last is the AdaIN feature; all three
    # feed the style loss of decoder training
    ENC_TAPS = (1, 3, 6)

    def __init__(self, encoder: VGG16Features | None = None,
                 decoder: AdaINDecoder | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if encoder is None:
            encoder = VGG16Features(self.ENC_TAPS, device=self.device,
                                    generator=generator)
        if decoder is None:
            decoder = AdaINDecoder(device=self.device, generator=generator)
        if tuple(encoder.taps) != self.ENC_TAPS:
            raise ValueError(f"the encoder's taps are {encoder.taps}, the "
                             f"stylizer needs {self.ENC_TAPS}")
        self.encoder = encoder.to(self.device).requires_grad_(False)
        self.decoder = decoder.to(self.device)

    @torch.no_grad()
    def _stylize(self, content, style, alpha):
        """NCHW content (N, 3, H, W) and style (N or 1, 3, H, W) in [0, 1],
        alpha (N,) -> NCHW stylized images clipped to [0, 1]."""
        c_feat = self.encoder.features(imagenet_normalise(content))[-1]
        s_feat = self.encoder.features(imagenet_normalise(style))[-1]
        t = adain(c_feat, s_feat)
        alpha = alpha.view(-1, 1, 1, 1)
        t = alpha * t + (1.0 - alpha) * c_feat
        return _denormalise(self.decoder.decode(t)).clamp(0.0, 1.0)

    def __call__(self, content, style, alpha=1.0):
        """Stylize a batch.

        Args:
          content: (N, H, W, 3) in [0, 1]; style: (N or 1, H, W, 3);
            tensors or numpy arrays, taken to the stylizer's device as f32.
          alpha: scalar or (N,) stylization strength (the alpha of the
            Styled-COCO directory names).
        Returns (N, H, W, 3) f32 on the stylizer's device.
        """
        dev = self.device
        content = torch.as_tensor(content, dtype=torch.float32, device=dev)
        style = torch.as_tensor(style, dtype=torch.float32, device=dev)
        alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                device=dev).broadcast_to(content.shape[:1])
        return self._stylize(content.permute(0, 3, 1, 2),
                             style.permute(0, 3, 1, 2),
                             alpha).permute(0, 2, 3, 1)


def adain_train_losses(encoder: VGG16Features, decoder: AdaINDecoder,
                       content, style, style_weight: float = 10.0,
                       recon_weight: float = 0.0):
    """The AdaIN decoder objective on NHWC (N, H, W, 3) batches in [0, 1]:
    content loss on relu3_3 plus ``style_weight`` times the style loss
    (mean and population std matched at every encoder tap); with
    ``recon_weight`` > 0, plus the pixel loss of decoding the unstylized
    content feature against the normalised content. The decoder's output
    goes to the encoder as it is (no normalisation), as in the JAX
    package. Returns (total, content_loss, style_loss)."""
    cn = imagenet_normalise(content.permute(0, 3, 1, 2))
    sn = imagenet_normalise(style.permute(0, 3, 1, 2))
    c_feat = encoder.features(cn)[-1]
    s_feats = encoder.features(sn)
    t = adain(c_feat, s_feats[-1])
    o_feats = encoder.features(decoder.decode(t))

    content_loss = torch.mean((o_feats[-1] - t) ** 2)
    style_loss = 0.0
    for of, sf in zip(o_feats, s_feats):
        style_loss = style_loss + torch.mean(
            (of.mean(dim=(2, 3)) - sf.mean(dim=(2, 3))) ** 2)
        style_loss = style_loss + torch.mean(
            (of.std(dim=(2, 3), correction=0) -
             sf.std(dim=(2, 3), correction=0)) ** 2)
    total = content_loss + style_weight * style_loss
    if recon_weight:
        recon = decoder.decode(c_feat)
        total = total + recon_weight * torch.mean((recon - cn) ** 2)
    return total, content_loss, style_loss


def train_adain_decoder(encoder: VGG16Features, decoder: AdaINDecoder,
                        batches, lr: float = 1e-4,
                        style_weight: float = 10.0,
                        recon_weight: float = 1.0, callback=None):
    """Train ``decoder`` in place over an iterable of (content, style)
    NHWC batches in [0, 1] (numpy or tensors), with Adam(lr) (b1 0.9, b2
    0.999, eps 1e-8 added after the square root, as optax's); the encoder
    is frozen (its parameters take no gradient, the graph runs through
    it). ``callback(step, loss)`` after each step. Returns (decoder, the
    per-step losses)."""
    encoder.requires_grad_(False)
    dev = next(decoder.parameters()).device
    opt = torch.optim.Adam(decoder.parameters(), lr=lr)
    history = []
    for content, style in batches:
        total, _, _ = adain_train_losses(
            encoder, decoder,
            torch.as_tensor(content, dtype=torch.float32, device=dev),
            torch.as_tensor(style, dtype=torch.float32, device=dev),
            style_weight=style_weight, recon_weight=recon_weight)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        history.append(float(total.detach()))
        if callback is not None:
            callback(len(history), history[-1])
    return decoder, history


def read_style_bank(style_dir: str, crop_hw) -> np.ndarray:
    """The style exemplars of ``style_dir`` (.jpg, .jpeg, .png, in name
    order), each read with cv2, made RGB and resized to (H, W) = crop_hw,
    as f32 in [0, 1]: (S, H, W, 3)."""
    import cv2

    files = [f for f in sorted(os.listdir(style_dir))
             if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    if not files:
        raise FileNotFoundError(f"no style exemplars in {style_dir}")
    H, W = crop_hw
    return np.stack([
        cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(style_dir, f)),
                                cv2.COLOR_BGR2RGB), (W, H))
        .astype(np.float32) / 255.0 for f in files])


def load_vgg_encoder(path: str, device="cuda") -> VGG16Features:
    """The stylizer's encoder from a torchvision vgg16 ``.pth``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return vgg16_from_torchvision(state, AdaINStylizer.ENC_TAPS, device)


def load_decoder_npz(path: str, device="cuda") -> AdaINDecoder:
    """A decoder from the JAX package's npz (``params``: the Flax dict)."""
    # imported here: models/convert.py imports this module
    from stlpose_tpu_torch.models.convert import adain_decoder_from_jax

    params = np.load(path, allow_pickle=True)["params"].item()
    return adain_decoder_from_jax({"params": params}, device)


def save_decoder_npz(path: str, decoder: AdaINDecoder):
    """Write ``decoder`` in the JAX package's npz format."""
    # imported here: models/convert.py imports this module
    from stlpose_tpu_torch.models.convert import adain_decoder_to_flax_params

    np.savez(path, params=np.asarray(adain_decoder_to_flax_params(decoder),
                                     dtype=object))


def build_inline_stylizer(inline_cfg, crop_hw=(256, 192), device="cuda"):
    """(stylizer, style_bank, alpha) from the ``dataset.inline_style``
    experiment parameter.

    Args:
      inline_cfg: dict with keys
        style_dir (required): directory of style exemplar images;
        decoder_ckpt: npz of a trained decoder
          (``scripts/aux_train_adain_decoder.py``); seeded init otherwise;
        vgg_weights: torchvision vgg16 ``.pth`` for the encoder; seeded
          random (fixed) features otherwise;
        alpha: stylization strength (default 1.0).
      crop_hw: (H, W) the exemplars are resized to (the pose crop shape,
        or the detection canvas).
      device: where the stylizer runs ("cuda" unless told otherwise).

    Returns (None, None, 1.0) when inline_cfg is falsy or has no
    style_dir.
    """
    device = resolve_device(device)
    if not inline_cfg or not inline_cfg.get("style_dir"):
        return None, None, 1.0
    bank = read_style_bank(inline_cfg["style_dir"], crop_hw)
    encoder = decoder = None
    if inline_cfg.get("vgg_weights"):
        encoder = load_vgg_encoder(inline_cfg["vgg_weights"], device)
    if inline_cfg.get("decoder_ckpt"):
        decoder = load_decoder_npz(inline_cfg["decoder_ckpt"], device)
    stylizer = AdaINStylizer(encoder, decoder, device=device)
    return stylizer, bank, float(inline_cfg.get("alpha", 1.0))
