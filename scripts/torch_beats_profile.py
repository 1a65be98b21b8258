#!/usr/bin/env python3
"""Where the time of the PyTorch port's embedding extraction and training goes, on one GPU.

    python3 scripts/torch_beats_profile.py [beats] [int8] [eat] [aves] [birdmae] [atst]
    python3 scripts/torch_beats_profile.py train [beats] [eat] [birdmae] [beats_remat] [beats_dots] [eat_ssl] [clip]
    python3 scripts/torch_beats_profile.py probe [attention] [transformer] [linear] [unfrozen]

Full-width models with seeded random weights, bf16, B=128, ``extract_embeddings``
over all layers with mean pooling: BEATs (12 layers, 768-d) on 5 s clips, the
same BEATs through ``load_model(quantization="int8")`` (``int8``: W8A8
encoder denses on the K7 kernel), EAT (the official
``esp_aves2_sl_eat_all_ssl_all`` entry, 12 blocks, T=513) on 10 s clips, AVES
(``aves_bio``, 12 layers, T=249) on 5 s clips with a third of them padded
from 3 s, Bird-MAE huge (``model_id`` ``DBD-research-group/Bird-MAE-huge``:
32 blocks, 1280-d, 16 heads of 80, T=513) on 10 s clips at 32 kHz, ATST-Frame
(12 blocks, 768-d, T=250) on 10 s clips. With no argument it profiles BEATs
and EAT. For the
kernel path (``use_pallas=True``) and the plain-attention path (``use_pallas``
unset) of each it prints the forward's wall time (CUDA-synchronised), the
device's busy share over that window (the union of the kernels' intervals:
some overlap) and the device kernels with the most summed time, from
``torch.profiler``. With ``train`` first it profiles one supervised
fine-tuning step instead (``Trainer``, AdamW, a 50-class head, B=64, bf16
compute with fp32 parameters; BEATs with ``fused_qkv``, so K2 forward and K3
backward, and EAT and Bird-MAE huge, K5 and K6; Bird-MAE's kernel path
only), after two warm-up steps. ``beats_remat`` and ``beats_dots`` are the
BEATs kernel-path step with gradient checkpointing (``remat_policy`` None,
then ``"dots"``); ``eat_ssl`` is a full-width EAT-SSL pretraining step
(``label_type="self_supervised"``, 10 s clips, both paths) and ``clip`` a
CLIP step (EfficientNet-B0 with ``esp_aves2_effnetb0_all``'s audio config
and RoBERTa-base, ``label_type="text"``, 10 s clips with captions, lr 1e-5;
no kernel of the port).
With ``probe`` first it profiles one ``FineTuneTrainer`` step of an online probe (B=64, 10
classes, bf16 backbone, fp32 head): ``attention`` and ``transformer``
presets over BEATs layers 3, 7, 11 and the last, frozen (K1 forward);
``linear`` over EAT's last layer, frozen (K5); ``unfrozen``: the attention
probe with the BEATs backbone trained, ``fused_qkv`` (K2 and K3). With no
name it profiles ``attention`` and ``linear``. Needs CUDA; imports nothing
of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, TOP = 128, 12
B_TRAIN, N_CLASSES = 64, 50
PROBE_CLASSES = 10


def _loader(name: str):
    """``(load(use_pallas), waveforms, padding_mask)`` for one model family."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec

    gen = torch.Generator("cuda").manual_seed(1)
    if name in ("beats", "int8"):
        official = OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"]

        def load(use_pallas):
            spec = ModelSpec(name="beats", pretrained=False, compute_dtype="bfloat16",
                             init_config=dict(official, use_pallas=use_pallas))
            return avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda",
                                             quantization="int8" if name == "int8" else None)

        return load, torch.randn(B, 5 * 16000, device="cuda", generator=gen) * 0.1, None
    if name == "eat":
        def load(use_pallas):
            return avex_tpu_torch.load_model(
                "esp_aves2_sl_eat_all_ssl_all", random_weights=True, return_features_only=True,
                device="cuda", compute_dtype="bfloat16", use_pallas=use_pallas,
            )

        return load, torch.randn(B, 10 * 16000, device="cuda", generator=gen) * 0.1, None
    if name == "aves":
        def load(use_pallas):
            spec = ModelSpec(name="aves_bio", pretrained=False, compute_dtype="bfloat16")
            return avex_tpu_torch.load_model(
                spec, random_weights=True, return_features_only=True, device="cuda", use_pallas=use_pallas
            )

        mask = torch.zeros(B, 5 * 16000, dtype=torch.bool, device="cuda")
        mask[::3, 3 * 16000:] = True
        return load, torch.randn(B, 5 * 16000, device="cuda", generator=gen) * 0.1, mask
    if name == "birdmae":
        wav = torch.randn(B, 10 * 32000, device="cuda", generator=gen) * 0.1
        return _birdmae_loader(return_features_only=True), wav, None
    if name == "atst":
        def load(use_pallas):
            spec = ModelSpec(name="atst", pretrained=False, compute_dtype="bfloat16")
            return avex_tpu_torch.load_model(
                spec, random_weights=True, return_features_only=True, device="cuda", use_pallas=use_pallas
            )

        return load, torch.randn(B, 10 * 16000, device="cuda", generator=gen) * 0.1, None
    raise SystemExit(f"unknown model {name!r} (beats, int8, eat, aves, birdmae, atst)")


def _birdmae_loader(**kwargs):
    """``load(use_pallas)`` of bf16 Bird-MAE huge through a ModelSpec's ``model_id``."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    def load(use_pallas):
        spec = ModelSpec(name="birdmae", pretrained=False, model_id="DBD-research-group/Bird-MAE-huge",
                         compute_dtype="bfloat16", init_config={"use_pallas": use_pallas})
        return avex_tpu_torch.load_model(spec, random_weights=True, device="cuda", **kwargs)

    return load


def _train_step(name: str, use_pallas):
    """A ``Trainer`` step function on one seeded batch of the named training."""
    import tempfile

    import torch

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
    from avex_tpu_torch.training import Trainer

    gen = torch.Generator("cuda").manual_seed(2)
    label_type, lr = "supervised", 3e-4
    if name in ("beats", "beats_remat", "beats_dots"):
        official = OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"]
        remat = {"beats": {}, "beats_remat": {"remat": True}, "beats_dots": {"remat": True, "remat_policy": "dots"}}
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype="bfloat16",
                         init_config=dict(official, fused_qkv=True, use_pallas=use_pallas, **remat[name]))
        model = avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cuda")
        samples = 5 * 16000
    elif name == "eat_ssl":
        from avex_tpu_torch.models import eat_ssl

        avex_tpu_torch.register_model_class("eat_ssl", eat_ssl.Model)
        model = avex_tpu_torch.build_model_from_spec(ModelSpec(name="eat_ssl", pretrained=False,
                                                               compute_dtype="bfloat16", eat_cfg={}),
                                                     device="cuda", use_pallas=use_pallas)
        samples, label_type = 10 * 16000, "self_supervised"
    elif name == "clip":
        audio = dict(OFFICIAL_MODELS["esp_aves2_effnetb0_all"]["model_spec"]["audio_config"])
        model = avex_tpu_torch.build_model_from_spec(ModelSpec(name="clip", pretrained=False, audio_config=audio,
                                                               compute_dtype="bfloat16", projection_dim=512),
                                                     device="cuda")
        samples, label_type, lr = 10 * 16000, "text", 1e-5
    elif name == "eat":
        model = avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True, num_classes=N_CLASSES,
                                          device="cuda", compute_dtype="bfloat16", use_pallas=use_pallas)
        samples = 10 * 16000
    elif name == "birdmae":
        model = _birdmae_loader(num_classes=N_CLASSES)(use_pallas)
        samples = 10 * 32000
    else:
        raise SystemExit(f"unknown model {name!r} for train ({', '.join(TRAIN_PATHS)})")
    batch = {"raw_wav": torch.randn(B_TRAIN, samples, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, N_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    if label_type == "text":
        batch["text_label"] = [f"a bird calling at dawn, recording {i}" for i in range(B_TRAIN)]
    config = RunConfig(model_spec={"name": name}, output_dir=tempfile.mkdtemp(), seed=0, label_type=label_type,
                       loss_function="clip" if label_type == "text" else "cross_entropy",
                       training_params=TrainingParams(train_epochs=1, lr=lr, batch_size=B_TRAIN, weight_decay=0.01),
                       scheduler=SchedulerConfig(name="cosine", warmup_steps=2))
    trainer = Trainer(model, config, [batch], steps_per_epoch=100)
    return lambda: trainer._train_step(batch), B_TRAIN


def _probe_step(name: str, use_pallas):
    """A ``FineTuneTrainer`` step function of one online probe on one seeded batch."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import PROBE_CONFIGS, ModelSpec, TrainingParams
    from avex_tpu_torch.evaluation import FineTuneTrainer
    from avex_tpu_torch.probes import build_probe_from_config

    gen = torch.Generator("cuda").manual_seed(3)
    if name == "linear":
        seconds = 10
        model = avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True,
                                          return_features_only=True, device="cuda", compute_dtype="bfloat16",
                                          use_pallas=use_pallas)
        config = PROBE_CONFIGS["linear"].replace(target_length=seconds * 16000)
    elif name in ("attention", "transformer", "unfrozen"):
        seconds = 5
        official = OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"]
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype="bfloat16",
                         init_config=dict(official, use_pallas=use_pallas, fused_qkv=name == "unfrozen"))
        model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
        config = PROBE_CONFIGS["transformer" if name == "transformer" else "attention"].replace(
            target_layers=[3, 7, 11, "last_layer"], target_length=seconds * 16000, freeze_backbone=name != "unfrozen")
    else:
        raise SystemExit(f"unknown probe {name!r} (attention, transformer, linear, unfrozen)")
    probe = build_probe_from_config(config, num_classes=PROBE_CLASSES, base_model=model)
    trainer = FineTuneTrainer(probe, TrainingParams(train_epochs=1, lr=1e-4, batch_size=B_TRAIN), mode="online")
    trainer._init_optimizer(100)
    batch = {"raw_wav": torch.randn(B_TRAIN, seconds * 16000, device="cuda", generator=gen) * 0.1,
             "label": torch.randint(0, PROBE_CLASSES, (B_TRAIN,), device="cuda", generator=gen)}
    return lambda: trainer._train_step(batch), B_TRAIN


def profile_call(title: str, run, clips: int) -> None:
    """Warm up, time one call of ``run`` (CUDA-synchronised), then profile one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    window_us = spans[-1][1] - spans[0][0]
    busy_us, reach = 0, spans[0][0]  # union of the kernels' intervals: some overlap
    for lo, hi in spans:
        busy_us += max(0, hi - max(lo, reach))
        reach = max(reach, hi)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"\n{title}: {wall_ms:.2f} ms unprofiled ({clips / wall_ms * 1e3:.1f} clips/s); "
          f"profiled: {len(kernels)} device kernels over {window_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms ({busy_us / window_us:.1%}), "
          f"summed kernel time {sum(by_name.values()):.2f} ms")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.3f} ms summed  {kname[:110]}")


PATHS = (("kernel path (use_pallas=True)", True), ("plain path (use_pallas unset)", None))
# Training: the paths each name profiles. Bird-MAE huge's plain path holds
# [B, 16, 513, 513] scores for 32 layers, past the card's memory at B=64;
# the remat steps are the kernel path's; CLIP runs no kernel of the port.
TRAIN_PATHS = {"beats": PATHS, "eat": PATHS, "birdmae": PATHS[:1], "beats_remat": PATHS[:1],
               "beats_dots": PATHS[:1], "eat_ssl": PATHS, "clip": (("no kernel of the port", None),)}


def profile_model(name: str) -> None:
    import torch

    load, wav, mask = _loader(name)
    for label, use_pallas in PATHS:
        model = load(use_pallas)
        model.register_hooks_for_layers(["all"])
        profile_call(f"{name} {label}, forward", lambda: model.extract_embeddings(
            wav, padding_mask=mask, aggregation="mean"), B)
        del model
        torch.cuda.empty_cache()


def profile_training(name: str, probe: bool = False) -> None:
    import torch

    for label, use_pallas in PATHS if probe else TRAIN_PATHS.get(name, PATHS):
        step, clips = (_probe_step if probe else _train_step)(name, use_pallas)
        torch.cuda.reset_peak_memory_stats()
        profile_call(f"{name} {label}, {'probe' if probe else 'training'} step", step, clips)
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del step
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    args = sys.argv[1:]
    mode = args[0] if args and args[0] in ("train", "probe") else None
    names = args[1:] if mode else args
    if mode == "probe":
        for name in names or ["attention", "linear"]:
            profile_training(name, probe=True)
    else:
        for name in names or ["beats", "eat"]:
            (profile_training if mode else profile_model)(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
