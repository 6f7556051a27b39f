"""The on-device encode stage (port of decafnet_tpu.encode): EgoVLP frame
transforms, the factorized clip encoder and the EgoVLP space-time ViT,
checkpoint import, and delegated encoding. ``python -m
decafnet_tpu_torch.encode`` writes the grounder's feature files."""

from .transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    center_crop,
    eval_transform,
    horizontal_flip,
    normalize,
    random_resized_crop,
    resize_bilinear,
    resize_short_side,
    train_transform,
)
from .encoder import (
    ClipEncoder,
    ClipEncoderRunner,
    encode_video,
    make_clip_encoder,
)
from .pipeline import (
    delegated_encode,
    encode_delegate_ground,
    expert_budget,
    gather_clips,
    select_salient_clips,
)
from .spacetime_vit import SpaceTimeViT
from .import_vit import (
    load_vit_checkpoint,
    normalize_vit_key,
    vit_state_dict_to_params,
)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "center_crop",
    "eval_transform",
    "horizontal_flip",
    "normalize",
    "random_resized_crop",
    "resize_bilinear",
    "resize_short_side",
    "train_transform",
    "ClipEncoder",
    "ClipEncoderRunner",
    "encode_video",
    "make_clip_encoder",
    "delegated_encode",
    "encode_delegate_ground",
    "expert_budget",
    "gather_clips",
    "select_salient_clips",
    "SpaceTimeViT",
    "load_vit_checkpoint",
    "normalize_vit_key",
    "vit_state_dict_to_params",
]
