#!/usr/bin/env python3
"""The unfrozen BEATs probe's training loss at three learning rates, on both attention paths.

    python3 scripts/torch_probe_lr.py

Full-width BEATs (the official config, bf16, ``fused_qkv=True``, seeded random
weights) with an attention probe over layers 3, 7, 11 and the last, trained
with its backbone (``freeze_backbone=False``) for six epochs of one step on
one batch of 64 tone clips (``chip_smoke.py``'s set), at lr 1e-4, 3e-5 and
1e-5, with the preset's head dropout (0.1) and without. Each setting runs on
the kernel path (``use_pallas=True``: K2 forward, K3 backward) and on the
plain path with the same weights, and prints the epochs' losses: the two
paths should track each other at every rate. Needs CUDA; imports nothing of
JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import torch

    import chip_smoke as cs
    from avex_tpu_torch.configs import PROBE_CONFIGS, TrainingParams

    batches = cs.tone_batches(5 * cs.B_PROBE, cs.CLIP_SAMPLES, seed=22)
    train, test = batches[:1], batches[4:]
    for use_pallas in (True, False):
        for drop in (0.1, 0.0):
            for lr in (1e-4, 3e-5, 1e-5):
                model = cs.load_beats("bfloat16", use_pallas=use_pallas, fused_qkv=True)
                config = PROBE_CONFIGS["attention"].replace(target_layers=cs.PROBE_LAYERS,
                                                            target_length=cs.CLIP_SAMPLES,
                                                            freeze_backbone=False, dropout_rate=drop)
                start = time.perf_counter()
                _, history, _ = cs.fine_tune(config, TrainingParams(train_epochs=6, lr=lr, batch_size=cs.B_PROBE),
                                             train, test, "online", base_model=model)
                print(f"pallas={use_pallas} drop={drop} lr={lr:g}: "
                      + " ".join(f"{r['train_loss']:.4f}" for r in history)
                      + f"  ({time.perf_counter() - start:.1f} s)", flush=True)
                del model
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
