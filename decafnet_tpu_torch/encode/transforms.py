"""Video frame transforms of the encode stage (port of
decafnet_tpu/encode/transforms.py): the EgoVLP eval and train pipelines.

  eval:  Resize(short side -> 256, bilinear) -> CenterCrop(256)
         -> Resize(224) -> Normalize(ImageNet mean/std)
  train: RandomResizedCrop(224, scale=(0.5, 1.0)) -> RandomHorizontalFlip
         -> Normalize

Frames are channel-last float32 ``(..., H, W, 3)`` in [0, 1], as in the JAX
package; scaling uint8 frames by 1/255 is the caller's job. The JAX package
resizes with two interpolation-weight matmuls (a TPU formulation); here
``F.interpolate(mode="bilinear", align_corners=False)`` computes the same
function on whatever device the frames are on, with or without antialias.
The random transforms draw their crop boxes and flips on the host from an
explicit ``torch.Generator`` (crops change shapes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(x, out_h, out_w, antialias=False):
    """Bilinear resize of the (H, W) axes of ``(..., H, W, C)``, as torch
    ``F.interpolate(bilinear, align_corners=False, antialias=...)``."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def resize_short_side(x, size, antialias=False):
    """torchvision Resize(int): scale the short side to ``size`` keeping the
    aspect ratio (the long side floors as torchvision's int arithmetic)."""
    h, w = x.shape[-3], x.shape[-2]
    if h <= w:
        out_h, out_w = size, max(1, int(size * w / h))
    else:
        out_h, out_w = max(1, int(size * h / w)), size
    return resize_bilinear(x, out_h, out_w, antialias=antialias)


def center_crop(x, size):
    """Center crop of the (H, W) axes; zero-pads first where smaller
    (torchvision semantics)."""
    h, w = x.shape[-3], x.shape[-2]
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                      pad_h // 2, pad_h - pad_h // 2))
        h, w = x.shape[-3], x.shape[-2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return x[..., top:top + size, left:left + size, :]


def normalize(x, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def eval_transform(x, center=256, input_res=224,
                   mean=IMAGENET_MEAN, std=IMAGENET_STD, antialias=False):
    """The EgoVLP val/test pipeline. ``antialias`` selects between the two
    torchvision Resize behaviours (no antialias on the tensor path of older
    pins, antialias at modern ones)."""
    x = resize_short_side(x, center, antialias=antialias)
    x = center_crop(x, center)
    x = resize_bilinear(x, input_res, input_res, antialias=antialias)
    return normalize(x, mean, std)


def random_resized_crop_box(h, w, generator, scale=(0.5, 1.0),
                            ratio=(3 / 4, 4 / 3), trials=10):
    """torchvision RandomResizedCrop's box (top, left, height, width): an
    area-scaled crop of log-uniform aspect, ``trials`` tries, then the
    center crop of the clamped aspect. Draws from ``generator`` (a CPU
    ``torch.Generator``)."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(trials):
        target = area * torch.empty(1).uniform_(*scale, generator=generator).item()
        r = math.exp(torch.empty(1).uniform_(*log_ratio, generator=generator).item())
        cw = int(round(math.sqrt(target * r)))
        ch = int(round(math.sqrt(target / r)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(torch.randint(0, h - ch + 1, (1,), generator=generator))
            left = int(torch.randint(0, w - cw + 1, (1,), generator=generator))
            return top, left, ch, cw
    in_r = w / h
    if in_r < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_r > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def resized_crop(x, box, size):
    """Crop ``box`` = (top, left, height, width) of the (H, W) axes and
    resize it to ``size`` x ``size``."""
    top, left, ch, cw = box
    return resize_bilinear(x[..., top:top + ch, left:left + cw, :], size, size)


def random_resized_crop(x, generator, size, scale=(0.5, 1.0),
                        ratio=(3 / 4, 4 / 3), trials=10):
    """torchvision RandomResizedCrop of the (H, W) axes, the box drawn from
    ``generator``."""
    box = random_resized_crop_box(x.shape[-3], x.shape[-2], generator,
                                  scale, ratio, trials)
    return resized_crop(x, box, size)


def horizontal_flip(x):
    return torch.flip(x, dims=(-2,))


def train_transform(x, generator, input_res=224, scale=(0.5, 1.0),
                    mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The EgoVLP train pipeline; its default ColorJitter(0, 0, 0) is the
    identity and is left out."""
    x = random_resized_crop(x, generator, input_res, scale=scale)
    if torch.rand(1, generator=generator).item() < 0.5:
        x = horizontal_flip(x)
    return normalize(x, mean, std)
