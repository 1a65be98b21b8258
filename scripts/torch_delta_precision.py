#!/usr/bin/env python3
"""How the bf16 attention backward's Δ moves the gradients of a whole model.

    python3 scripts/torch_delta_precision.py [--batch 3]

Runs on the CPU. The bf16 K6 on the card takes Δ = rowsum(dO ∘ O) from the
forward's output instead of JAX's rowsum(P ∘ dP). This script emulates that
with the plain twins: full-width AVES (``aves_bio``, 12 layers, 768-d,
random weights from a seed, a 50-class head, 5 s clips with a third padded
from 3 s) takes one bf16 step whose fused attention's backward is

- ``exact``: the backward twin, Δ = rowsum(P ∘ dP) as JAX computes it;
- ``out``: the residual twin with Δ from the output rounded to bf16;
- ``out+rest``: the residual twin with Δ from the output plus what its
  rounding dropped (what the kernel does);

and prints each one's distance from the fp32 plain path's gradients (global
relative L2 over every parameter, the key bias left out as in
``chip_smoke.py``) beside the bf16 plain path's, with the worst tensor.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CLIP_SAMPLES, PAD_FROM, N_CLASSES = 5 * 16000, 3 * 16000, 50


def main() -> int:
    import torch

    import avex_tpu_torch
    import avex_tpu_torch.models.aves as aves
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.ops import attention_kernels as ak
    from avex_tpu_torch.training.losses import cross_entropy_loss

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=3)
    parser.add_argument("--seed", type=int, default=11)
    args = parser.parse_args()

    class Emulated(torch.autograd.Function):
        """The twins' forward; the backward of the chosen Δ."""

        delta = "exact"

        @staticmethod
        def forward(ctx, qkv, mask, heads, scale):
            out, lse, rest = ak._fused_qkv_forward_lse_reference(qkv, heads, mask, scale)
            ctx.save_for_backward(qkv, mask, out, lse, rest)
            ctx.heads, ctx.scale = heads, scale
            return out

        @staticmethod
        def backward(ctx, dout):
            qkv, mask, out, lse, rest = ctx.saved_tensors
            if Emulated.delta == "exact":
                return ak.fused_qkv_backward_reference(qkv, ctx.heads, mask, dout, ctx.scale), None, None, None
            dqkv, _, _ = ak.fused_qkv_backward_from_residuals_reference(
                qkv, out, lse, mask, dout, ctx.scale, out_rest=rest if Emulated.delta == "out+rest" else None)
            return dqkv, None, None, None

    aves.fused_qkv_attention = lambda qkv, heads, key_padding_mask=None, scale=None: Emulated.apply(
        qkv, key_padding_mask, heads, scale)

    gen = torch.Generator().manual_seed(args.seed)
    wav = torch.randn(args.batch, CLIP_SAMPLES, generator=gen) * 0.1
    mask = torch.zeros(args.batch, CLIP_SAMPLES, dtype=torch.bool)
    mask[::3, PAD_FROM:] = True
    labels = torch.arange(args.batch) % N_CLASSES

    def gradients(dtype, fused):
        spec = ModelSpec(name="aves_bio", pretrained=False, compute_dtype=dtype)
        model = avex_tpu_torch.load_model(spec, random_weights=True, num_classes=N_CLASSES, device="cpu",
                                          use_pallas=fused)
        params = dict(model.module.named_parameters())
        out, _ = model.train_forward(wav, mask)
        grads = torch.autograd.grad(cross_entropy_loss(out, labels), list(params.values()), allow_unused=True)
        return {n: g.float() for n, g in zip(params, grads) if g is not None}

    def distance(grads, ref):
        num = den = worst = 0.0
        worst_name = ""
        for name, want in ref.items():
            if name.endswith("k_proj.bias"):  # 0 in exact arithmetic: rounding noise on every path
                continue
            d2, n2 = float((grads[name] - want).norm() ** 2), float(want.norm() ** 2)
            num, den = num + d2, den + n2
            if n2 and (d2 / n2) ** 0.5 > worst:
                worst, worst_name = (d2 / n2) ** 0.5, name
        return (num / den) ** 0.5, worst, worst_name

    ref = gradients("float32", False)
    rows = [("bf16 plain path", gradients("bfloat16", False))]
    for delta in ("exact", "out", "out+rest"):
        Emulated.delta = delta
        rows.append((f"bf16 fused, delta from {delta}", gradients("bfloat16", True)))
    print(f"AVES, B={args.batch}, one step, gradients against the fp32 plain path (CPU)")
    for label, grads in rows:
        total, worst, name = distance(grads, ref)
        print(f"  {label}: global rel L2 {total:.3e}, worst tensor {worst:.3e} ({name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
