#!/usr/bin/env python3
"""CLIP's first training steps from random towers at several learning rates.

    python3 scripts/torch_clip_lr.py [LR ...] [--batch 16] [--seconds 2] [--device cpu]

Full-width CLIP (EfficientNet-B0 with the ``esp_aves2_effnetb0_all`` audio
config, RoBERTa-base, projection 512) takes 11 ``Trainer`` steps
(``label_type="text"``, AdamW, cosine schedule with 2 warm-up steps) on one
batch of tone clips, one tone a class (10 classes), with captions that name
the class; prints each learning rate's losses. The random towers map the
clips close together, so the loss starts near ln(batch); this shows which
rate makes it fall (``chip_smoke.py`` phase 28 picks its rate from it).
Defaults: 3e-4, 1e-4 and 1e-5 on the CPU in fp32.
"""

from __future__ import annotations

import argparse
import math
import tempfile
import time

import torch

from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models.factory import build_model_from_spec
from avex_tpu_torch.training import Trainer

SPECIES = ("warbler", "thrush", "frog", "cricket", "owl", "wren", "cicada", "gull", "loon", "katydid")


def tone_batch(bsz: int, samples: int, seed: int = 28):
    """``bsz`` clips: class c a tone near 250 + 700·c Hz over noise; captions naming the class."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randperm(bsz, generator=gen) % len(SPECIES)
    t = torch.arange(samples) / 16000.0
    freq = (250.0 + 700.0 * labels) * (1.0 + 0.03 * (2 * torch.rand(bsz, generator=gen) - 1))
    wav = 0.1 * torch.sin(2 * math.pi * freq[:, None] * t[None]) + 0.025 * torch.randn(bsz, samples, generator=gen)
    texts = [f"a {SPECIES[int(c)]} calling at dawn, recording {i}" for i, c in enumerate(labels)]
    return {"raw_wav": wav, "text_label": texts}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("lrs", nargs="*", type=float, default=[3e-4, 1e-4, 1e-5])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--dtype", default="float32")
    args = parser.parse_args()
    batch = tone_batch(args.batch, int(args.seconds * 16000))
    audio = dict(OFFICIAL_MODELS["esp_aves2_effnetb0_all"]["model_spec"]["audio_config"])
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "the CPU"
    print(f"CLIP, B={args.batch}, {args.seconds:g} s tone clips, {args.dtype}, on {where}; ln B = {math.log(args.batch):.4f}")
    for lr in args.lrs:
        spec = ModelSpec(name="clip", pretrained=False, audio_config=audio, projection_dim=512,
                         compute_dtype=args.dtype)
        model = build_model_from_spec(spec, device=args.device)
        with tempfile.TemporaryDirectory() as out:
            config = RunConfig(
                model_spec={"name": "clip"}, label_type="text", loss_function="clip", output_dir=out, seed=0,
                training_params=TrainingParams(train_epochs=1, lr=lr, batch_size=args.batch, optimizer="adamw",
                                               weight_decay=0.01),
                scheduler=SchedulerConfig(name="cosine", warmup_steps=2), device=args.device,
            )
            trainer = Trainer(model, config, [], steps_per_epoch=20)
            start = time.perf_counter()
            losses = [trainer._train_step(batch)[0].item() for _ in range(11)]
        print(f"lr {lr:g}: " + " ".join(f"{x:.4f}" for x in losses) + f" ({time.perf_counter() - start:.0f} s)",
              flush=True)


if __name__ == "__main__":
    main()
