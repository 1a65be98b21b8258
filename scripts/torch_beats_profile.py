#!/usr/bin/env python3
"""Where the time of the PyTorch port's embedding extraction goes, on one GPU.

    python3 scripts/torch_beats_profile.py [beats] [int8] [eat] [aves]

Full-width models with seeded random weights, bf16, B=128, ``extract_embeddings``
over all layers with mean pooling: BEATs (12 layers, 768-d) on 5 s clips, the
same BEATs through ``load_model(quantization="int8")`` (``int8``: W8A8
encoder denses on the K7 kernel), EAT (the official
``esp_aves2_sl_eat_all_ssl_all`` entry, 12 blocks, T=513) on 10 s clips, AVES
(``aves_bio``, 12 layers, T=249) on 5 s clips with a third of them padded
from 3 s. With no argument it profiles BEATs and EAT. For the
kernel path (``use_pallas=True``) and the plain-attention path (``use_pallas``
unset) of each it prints the forward's wall time (CUDA-synchronised), the
device's busy share over that window (the union of the kernels' intervals:
some overlap) and the device kernels with the most summed time, from
``torch.profiler``. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, TOP = 128, 12


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
    raise SystemExit(f"unknown model {name!r} (beats, int8, eat, aves)")


def profile_model(name: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    load, wav, mask = _loader(name)
    for label, use_pallas in (("kernel path (use_pallas=True)", True), ("plain path (use_pallas unset)", None)):
        model = load(use_pallas)
        model.register_hooks_for_layers(["all"])
        for _ in range(3):
            model.extract_embeddings(wav, padding_mask=mask, aggregation="mean")
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.extract_embeddings(wav, padding_mask=mask, aggregation="mean")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.extract_embeddings(wav, padding_mask=mask, aggregation="mean")
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
        print(f"\n{name} {label}: forward {wall_ms:.2f} ms unprofiled ({B / wall_ms * 1e3:.1f} clips/s); "
              f"profiled: {len(kernels)} device kernels over {window_us / 1e3:.2f} ms, "
              f"device busy {busy_us / 1e3:.2f} ms ({busy_us / window_us:.1%}), "
              f"summed kernel time {sum(by_name.values()):.2f} ms")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
            print(f"  {ms:9.3f} ms summed  {kname[:110]}")
        del model
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name in sys.argv[1:] or ["beats", "eat"]:
        profile_model(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
