"""Feature-encoding CLI of the port (the counterpart of the root
``encode.py``): raw frames in, the grounder's feature files out::

    python -m decafnet_tpu_torch.encode --frames_dir F --out_expert_dir E
        [--out_sidekick_dir S] [--expert spacetime|factorized]
        [--sidekick spacetime|factorized] [--expert_ckpt egovlp.pth]
        [--sidekick_ckpt s.pth] [--expert_opt '{"dim": 768, ...}']
        [--sidekick_opt '{"depth": 2, ...}'] [--frames 4] [--resize 256]
        [--input_res 224] [--sidekick_res 112] [--antialias] [--seed 0]
        [--device cuda|cpu]

Frame files are ``{vid_id}.npy`` of shape (num_clips, frames_per_clip, H,
W, 3), uint8 or float32 in [0, 1]; each becomes a (num_clips, C) float32
``{vid_id}.npy`` per stream. Frames go through the EgoVLP eval transform
(only normalized when already at the encoder's resolution) and the
encoders on the device, a runner's clip cap at a time. With a checkpoint
the space-time ViT loads an EgoVLP state dict (a factorized encoder loads
its own state dict); without one the encoder runs seeded synthetic weights
and says so: such features are well-formed but carry no meaning. A
``"dtype": "bfloat16"`` in ``--expert_opt`` / ``--sidekick_opt`` runs a
factorized encoder in bf16 (its features are written f32); the space-time
ViT has no ``dtype`` field and drops it, as ``encode.py`` does, so it runs
in f32. Runs on the CUDA card unless ``--device`` says otherwise; raises
where there is none.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np
import torch

from ..eval.evaluator import resolve_device
from .encoder import ClipEncoderRunner, make_clip_encoder
from .import_vit import load_vit_checkpoint
from .spacetime_vit import SpaceTimeViT
from .transforms import eval_transform, normalize


def build_runner(kind, opt, ckpt, input_res, frames, seed, device):
    """(runner, weights label) of one encoder on ``device``. ``opt`` keys the
    encoder does not take are dropped: ``dtype`` reaches the factorized
    encoder only."""
    fields = {"img_size": input_res, "frames": frames, **opt}
    if kind == "spacetime":
        allowed = set(inspect.signature(SpaceTimeViT).parameters)
        model = SpaceTimeViT(**{k: v for k, v in fields.items() if k in allowed})
    else:
        model = make_clip_encoder(fields)
    if ckpt and kind == "spacetime":
        load_vit_checkpoint(model, ckpt)
    elif ckpt:
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(state.get("state_dict", state), strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    label = (f"checkpoint {ckpt}" if ckpt else
             f"seeded synthetic weights (seed {seed}): features carry no meaning")
    return ClipEncoderRunner(model.to(device)), label


def encode_one(frames, runner, resize, input_res, antialias):
    """(T, F, H, W, 3) raw frames (numpy) -> (T, C) float32 features."""
    feats = []
    for i in range(0, frames.shape[0], runner.max_clips):
        x = torch.from_numpy(np.ascontiguousarray(frames[i:i + runner.max_clips]))
        x = x.to(runner.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        if x.shape[-3] == input_res and x.shape[-2] == input_res:
            x = normalize(x)
        else:
            x = eval_transform(x, center=resize, input_res=input_res,
                               antialias=antialias)
        feats.append(runner.encode(x))
    return torch.cat(feats, dim=1).T.cpu().numpy()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m decafnet_tpu_torch.encode",
        description="Encode raw frames into expert / sidekick feature files.")
    parser.add_argument("--frames_dir", required=True)
    parser.add_argument("--out_expert_dir", required=True)
    parser.add_argument("--out_sidekick_dir", default=None)
    parser.add_argument("--expert_ckpt", default=None)
    parser.add_argument("--sidekick_ckpt", default=None)
    parser.add_argument("--expert", default=None,
                        choices=[None, "spacetime", "factorized"],
                        help="default: spacetime with --expert_ckpt, "
                             "factorized otherwise")
    parser.add_argument("--sidekick", default="factorized",
                        choices=["spacetime", "factorized"])
    parser.add_argument("--expert_opt", default="{}",
                        help="JSON encoder-field overrides")
    parser.add_argument("--sidekick_opt", default="{}")
    parser.add_argument("--frames", type=int, default=4, help="frames per clip")
    parser.add_argument("--resize", type=int, default=256)
    parser.add_argument("--input_res", type=int, default=224)
    parser.add_argument("--sidekick_res", type=int, default=None,
                        help="lower sidekick resolution (default input_res)")
    parser.add_argument("--antialias", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    expert_kind = args.expert or ("spacetime" if args.expert_ckpt else "factorized")
    sk_res = args.sidekick_res or args.input_res

    expert, label = build_runner(expert_kind, json.loads(args.expert_opt),
                                 args.expert_ckpt, args.input_res, args.frames,
                                 args.seed, device)
    print(f"device: {device}; expert: {expert_kind}, {label}", flush=True)
    sidekick = None
    if args.out_sidekick_dir:
        sidekick, label = build_runner(args.sidekick, json.loads(args.sidekick_opt),
                                       args.sidekick_ckpt, sk_res, args.frames,
                                       args.seed + 1, device)
        print(f"sidekick: {args.sidekick}, {label}", flush=True)
        os.makedirs(args.out_sidekick_dir, exist_ok=True)
    os.makedirs(args.out_expert_dir, exist_ok=True)

    names = sorted(f for f in os.listdir(args.frames_dir) if f.endswith(".npy"))
    if not names:
        raise FileNotFoundError(f"no .npy frame files in {args.frames_dir}")
    for i, fname in enumerate(names):
        frames = np.load(os.path.join(args.frames_dir, fname))
        if frames.ndim != 5 or frames.shape[-1] != 3:
            raise ValueError(f"{fname}: expected (T, F, H, W, 3), got {frames.shape}")
        feat = encode_one(frames, expert, args.resize, args.input_res, args.antialias)
        np.save(os.path.join(args.out_expert_dir, fname), feat)
        if sidekick is not None:
            sk = encode_one(frames, sidekick, args.resize, sk_res, args.antialias)
            np.save(os.path.join(args.out_sidekick_dir, fname), sk)
        print(f"[{i + 1}/{len(names)}] {fname}: {frames.shape} -> {feat.shape}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
