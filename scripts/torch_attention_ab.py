#!/usr/bin/env python3
"""Device time of the bf16 attention kernels at head widths 64 and 80, from one checkout.

    python3 scripts/torch_attention_ab.py [CHECKOUT]

Imports ``avex_tpu_torch`` from CHECKOUT (default: this one), builds its
``tensor_core_attention.cu`` and prints one line ``AB <checkout> K5=.. K4=..
K1=.. K2=.. K6=.. K3=.. K5@80=.. K6@80=..``: the median of 50 launches,
each queued behind a sleep kernel between two CUDA events, at the main
paths' shapes (K5 and K4: EAT, B=128, T=513; K1 and K2: BEATs, B=128,
T=248, with the gate; K6: EAT's training batch, B=64; K3: BEATs', B=64;
K5@80 and K6@80: Bird-MAE huge's, 16 heads of 80, B=128 and 64, T=513).
Two checkouts are compared on one card by
running it on each in turns (parent, change, change, parent), e.g. with the
parent unpacked by ``git archive`` into ``build/parent``. Needs CUDA and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

CHECKOUT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(CHECKOUT))
H, D = 12, 64
SLEEP_CYCLES = 4_000_000


def median_ms(fn, n: int = 50) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> int:
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    split = [randn(128, 248, H * D).bfloat16().view(128, 248, H, D).permute(0, 2, 1, 3) for _ in range(3)]
    eat = randn(128, 513, 3 * H * D).bfloat16()
    q, k, v = (t.permute(0, 2, 1, 3) for t in eat.view(128, 513, 3, H, D).unbind(2))
    beats = randn(128, 248, 3 * H * D).bfloat16()
    bias, gate = randn(H, 248, 248), torch.rand(128, H, 248, device="cuda", generator=gen) + 1
    eat_train, eat_dout = randn(64, 513, 3 * H * D).bfloat16().requires_grad_(), randn(64, 513, H * D).bfloat16()
    eat_out = ak.fused_qkv_attention(eat_train, H)
    leaves = (randn(64, 248, 3 * H * D).bfloat16().requires_grad_(), bias.clone().requires_grad_(),
              gate[:64].clone().requires_grad_())
    beats_dout = randn(64, 248, H * D).bfloat16()
    beats_out = ak.fused_qkv_gated_attention(leaves[0], H, leaves[1], leaves[2])
    with torch.no_grad():
        times = {"K5": median_ms(lambda: ak.fused_qkv_attention(eat, H)),
                 "K4": median_ms(lambda: ak.gated_bias_attention(q, k, v, None)),
                 "K1": median_ms(lambda: ak.gated_bias_attention(*split, bias, gate)),
                 "K2": median_ms(lambda: ak.fused_qkv_gated_attention(beats, H, bias, gate))}
    times["K6"] = median_ms(lambda: torch.autograd.grad(eat_out, (eat_train,), eat_dout, retain_graph=True))
    times["K3"] = median_ms(lambda: torch.autograd.grad(beats_out, leaves, beats_dout, retain_graph=True))
    del eat, q, k, v, beats, eat_train, eat_out, leaves, beats_out, split
    mae = randn(128, 513, 3 * 16 * 80).bfloat16()
    with torch.no_grad():
        times["K5@80"] = median_ms(lambda: ak.fused_qkv_attention(mae, 16))
    mae_train, mae_dout = mae[:64].clone().requires_grad_(), randn(64, 513, 16 * 80).bfloat16()
    mae_out = ak.fused_qkv_attention(mae_train, 16)
    times["K6@80"] = median_ms(lambda: torch.autograd.grad(mae_out, (mae_train,), mae_dout, retain_graph=True))
    print(f"AB {CHECKOUT} " + " ".join(f"{name}={ms:.4f}" for name, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
