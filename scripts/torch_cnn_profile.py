#!/usr/bin/env python3
"""Where the time of the port's CNNs goes on one GPU, in both memory layouts.

    python3 scripts/torch_cnn_profile.py [effnet] [effnet32] [perch] [resnet152] [train]

Full-width models with seeded random weights, ``extract_embeddings`` over
every tap at B=128: EfficientNet-B0 as the official ``esp_aves2_effnetb0_all``
entry builds it (10 s at 16 kHz, 1001 frames of 128 mels; ``effnet`` bf16,
``effnet32`` fp32 under ``full_fp32()``: no TF32), Perch (EfficientNet-B1, 5 s at 32
kHz; ``infer``) and ResNet-152 at EfficientNet's audio config (the four taps
unpooled); ``train``: one EfficientNet-B0 ``Trainer`` step (bf16, B=64, a
50-class head, AdamW) after two warm-up steps. Each runs with activations in
``channels_last`` memory (NHWC, JAX's convolution layout) and in NCHW, in
turns (NHWC, NCHW, NCHW, NHWC), printing for each call its wall time
(CUDA-synchronised), the device's busy share and the kernels with the most
summed time (``torch_beats_profile.profile_call``). With no argument:
``effnet train``. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_beats_profile import profile_call  # noqa: E402  (this directory)

B, B_TRAIN, N_CLASSES = 128, 64, 50
EFFNET = "esp_aves2_effnetb0_all"


def _call(name: str):
    """``(model, run)`` for one configuration: ``run()`` is one call at B=128
    (a ``Trainer`` step at B=64 for ``train``)."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
    from avex_tpu_torch.ops._precision import full_fp32
    from avex_tpu_torch.training import Trainer

    gen = torch.Generator("cuda").manual_seed(4)
    if name in ("effnet", "effnet32"):
        model = avex_tpu_torch.load_model(EFFNET, random_weights=True, return_features_only=True, device="cuda",
                                          compute_dtype="bfloat16" if name == "effnet" else "float32")
        model.register_hooks_for_layers(["all"])
        wav = torch.randn(B, 10 * 16000, device="cuda", generator=gen) * 0.1
        if name == "effnet":
            return model, lambda: model.extract_embeddings(wav, aggregation="mean")

        def run():
            with full_fp32():
                return model.extract_embeddings(wav, aggregation="mean")

        return model, run
    if name == "perch":
        model = avex_tpu_torch.load_model(ModelSpec(name="perch", pretrained=False, compute_dtype="bfloat16"),
                                          random_weights=True, device="cuda")
        wav = torch.randn(B, 5 * 32000, device="cuda", generator=gen) * 0.1
        return model, lambda: model.infer(wav)
    if name == "resnet152":
        audio = dict(OFFICIAL_MODELS[EFFNET]["model_spec"]["audio_config"])
        model = avex_tpu_torch.load_model(
            ModelSpec(name="resnet152", pretrained=False, audio_config=audio, compute_dtype="bfloat16"),
            random_weights=True, return_features_only=True, device="cuda")
        model.register_hooks_for_layers(["all"])
        wav = torch.randn(B, 10 * 16000, device="cuda", generator=gen) * 0.1
        return model, lambda: model.extract_embeddings(wav, aggregation="none")
    if name == "train":
        model = avex_tpu_torch.load_model(EFFNET, random_weights=True, num_classes=N_CLASSES, device="cuda",
                                          compute_dtype="bfloat16")
        batch = {"raw_wav": torch.randn(B_TRAIN, 10 * 16000, device="cuda", generator=gen) * 0.1,
                 "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
        config = RunConfig(model_spec={"name": "efficientnet"}, output_dir=tempfile.mkdtemp(), seed=0,
                           training_params=TrainingParams(train_epochs=1, lr=3e-4, batch_size=B_TRAIN,
                                                          weight_decay=0.01),
                           scheduler=SchedulerConfig(name="cosine", warmup_steps=2))
        trainer = Trainer(model, config, [batch], steps_per_epoch=100)
        return model, lambda: trainer._train_step(batch)
    raise SystemExit(f"unknown configuration {name!r} (effnet, effnet32, perch, resnet152, train)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name in sys.argv[1:] or ["effnet", "train"]:
        model, run = _call(name)
        clips = B_TRAIN if name == "train" else B
        for channels_last in (True, False, False, True):
            model.module.channels_last = channels_last
            torch.cuda.reset_peak_memory_stats()
            profile_call(f"{name} {'channels_last (NHWC)' if channels_last else 'NCHW'}", run, clips)
            print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
