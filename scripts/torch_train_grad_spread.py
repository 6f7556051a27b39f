#!/usr/bin/env python3
"""How far the port's train gradients through the CUDA kernels lie from the
same gradients through the plain PyTorch versions, batch by batch.

    python3 scripts/torch_train_grad_spread.py

Writes the synthetic train split of ``chip_smoke.py``'s train phase, builds
the Trainer through the train CLI's ``build_trainer`` on
configs/ego4d_nlq.yaml (16 videos x 2 queries per step, T = 2304), trains
its 4 steps, then for 4 distinct batches, in train mode (dropout, the same
masks on both paths) and in eval mode, computes one microbatch's gradients
with the kernels and with the plain versions (cuDNN's deterministic
algorithms) and prints one JSON line each: the elementwise worst over
rtol 1e-3 + 1e-4 of the leaf's largest |g| with its leaves, the leaves with
the largest relative L2 distance, and the relative L2 distance of all
gradients together. The last line is the card's name and power limit. This
is the spread behind the tolerances of ``chip_smoke.py``'s gradient check.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import chip_smoke as cs
    import decafnet_tpu_torch  # noqa: F401  (sets full f32: TF32 off)
    from decafnet_tpu_torch.ops import cuda
    from decafnet_tpu_torch.train.__main__ import build_trainer, train
    from decafnet_tpu_torch.train.trainer import _to_device

    cuda.library()
    with tempfile.TemporaryDirectory() as root:
        argv = ["--cfg", os.path.join(REPO, "configs", "ego4d_nlq.yaml"),
                cs.write_train_data(root), "--set", "log.root",
                os.path.join(root, "log"), "seed", str(cs.SEED),
                "train.epochs", "1", "train.warmup_epochs", "1"]
        trainer = build_trainer(argv)
        train(trainer)
        model, n = trainer.model, trainer.cfg.train.batch_size

        def grads(batch, plain, seed):
            trainer.generator.manual_seed(seed)
            if plain:
                with cuda.plain_versions():
                    trainer.accumulate(batch)
            else:
                trainer.accumulate(batch)
            return {k: p.grad.detach().clone()
                    for k, p in model.named_parameters() if p.grad is not None}

        torch.backends.cudnn.deterministic = True
        for b in range(4):
            # epochs 0 and 1 hold different crops of the 32 samples
            trainer.dataset.set_epoch(b // 2)
            idx = range(n * (b % 2), n * (b % 2 + 1))
            batch = _to_device(trainer.loader.transform(
                [trainer.dataset[i] for i in idx]), trainer.device)
            for mode in ("train", "eval"):
                getattr(model, mode)()
                got, want = grads(batch, False, b), grads(batch, True, b)
                elem, _, elem_top = cs.grads_close(got, want)
                rel_all, rel_top = cs.grads_rel_l2(got, want)
                cs.emit({"batch": b, "mode": mode,
                         "elementwise_worst_over_tol": elem,
                         "elementwise_worst_leaves": elem_top[:2],
                         "rel_l2_worst_leaves": rel_top, "rel_l2_all": rel_all})
        model.train()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    main()
