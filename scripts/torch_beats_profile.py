#!/usr/bin/env python3
"""Where the time of the PyTorch port's BEATs extraction goes, on one GPU.

    python3 scripts/torch_beats_profile.py

Full-width BEATs (12 layers, 768-d, seeded random weights), bf16, B=128 clips
of 5 s, ``extract_embeddings`` over all 13 layers with mean pooling. For the
kernel path (``use_pallas=True``) and the plain-attention path (``use_pallas``
unset) it prints the forward's wall time (CUDA-synchronised), the device's
busy share over that window (the union of the kernels' intervals: some
overlap) and the device kernels with the most summed time, from
``torch.profiler``. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, CLIP_SAMPLES, TOP = 128, 5 * 16000, 12


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    official = OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"]
    wav = torch.randn(B, CLIP_SAMPLES, device="cuda", generator=torch.Generator("cuda").manual_seed(1)) * 0.1

    for label, use_pallas in (("kernel path (use_pallas=True)", True), ("plain path (use_pallas unset)", None)):
        spec = ModelSpec(name="beats", pretrained=False, compute_dtype="bfloat16",
                         init_config=dict(official, use_pallas=use_pallas))
        model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
        model.register_hooks_for_layers(["all"])
        for _ in range(3):
            model.extract_embeddings(wav, aggregation="mean")
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.extract_embeddings(wav, aggregation="mean")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.extract_embeddings(wav, aggregation="mean")
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
        print(f"\n{label}: forward {wall_ms:.2f} ms unprofiled ({B / wall_ms * 1e3:.1f} clips/s); "
              f"profiled: {len(kernels)} device kernels over {window_us / 1e3:.2f} ms, "
              f"device busy {busy_us / 1e3:.2f} ms ({busy_us / window_us:.1%}), "
              f"summed kernel time {sum(by_name.values()):.2f} ms")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
            print(f"  {ms:9.3f} ms summed  {name[:110]}")
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
