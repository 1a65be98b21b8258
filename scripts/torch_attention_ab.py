#!/usr/bin/env python3
"""Device time of the bf16 attention kernels at head widths 64 and 80, from one checkout.

    python3 scripts/torch_attention_ab.py [CHECKOUT] [fp32]

Imports ``avex_tpu_torch`` from CHECKOUT (default: this one), builds its
``tensor_core_attention.cu`` and prints one line ``AB <checkout> K5=.. K4=..
K1=.. K2=.. K6=.. K3=.. K5@80=.. K6@80=..``: the median of 50 launches,
each queued behind a sleep kernel between two CUDA events, at the main
paths' shapes (K5 and K4: EAT, B=128, T=513; K1 and K2: BEATs, B=128,
T=248, with the gate; K6: EAT's training batch, B=64; K3: BEATs', B=64;
K5@80 and K6@80: Bird-MAE huge's, 16 heads of 80, B=128 and 64, T=513).
With ``fp32`` it times the fp32 forwards instead (K5, K4, K1, K2, K5@80 at
the same shapes, the median of 20) and prints a second line ``AB-clips
<checkout> beats=.. eat=..``: the fp32 extraction clips/s of the official
BEATs (``chip_smoke.load_beats`` of the checkout, ``use_pallas=True``: K1)
and EAT (K5) at B=128 (5 s and 10 s clips,
all layers mean-pooled, the median of 8 timed batches after one warm-up),
then for each model one line ``AB-path <checkout> <model> ...``: the
attention launches and forward bodies of one batch (``FORWARD_BODIES``,
where the checkout has it), the host wall time of a batch and the host's
time until the call returned (near the wall time: the host bounds the
batch), and one profiled
batch's device busy time (the union of its kernels' intervals) and its five
longest kernels, which say whether the attention kernel's time can show in
clips/s.
Two checkouts are compared on one card by
running it on each in turns (parent, change, change, parent), e.g. with the
parent unpacked by ``git archive`` into ``build/parent``. Needs CUDA and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

ARGS = [a for a in sys.argv[1:] if a != "fp32"]
FP32 = "fp32" in sys.argv[1:]
CHECKOUT = Path(ARGS[0] if ARGS else Path(__file__).resolve().parents[1]).resolve()
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


def batch_path(model, wav, ak) -> str:
    """One batch's attention launches and forward bodies, its host wall ms and
    the host ms until the call returned, and one profiled batch's device busy
    ms and five longest kernels (device ms summed over launches)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    ak.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    model.extract_embeddings(wav, aggregation="mean")
    returned = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    wall = (time.perf_counter() - start) * 1e3
    launches = {k: v for k, v in ak.LAUNCHES.items() if v}
    bodies = dict(getattr(ak, "FORWARD_BODIES", {}))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.extract_embeddings(wav, aggregation="mean")
        torch.cuda.synchronize()
    spans, per_kernel = [], {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA and event.time_range.elapsed_us() > 0:
            spans.append((event.time_range.start, event.time_range.end))
            per_kernel[event.name] = per_kernel.get(event.name, 0.0) + event.time_range.elapsed_us() / 1e3
    busy, reach = 0.0, None
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            busy, reach = busy + hi - lo, hi
        elif hi > reach:
            busy, reach = busy + hi - reach, hi
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    return (f"launches={launches} bodies={bodies} wall_ms={wall:.2f} returned_ms={returned:.2f} busy_ms={busy / 1e3:.2f} top: "
            + "; ".join(f"{name[:70]}={ms:.2f}" for name, ms in top))


def fp32_main() -> int:
    """The fp32 forwards' device times and the fp32 extraction clips/s."""
    import time

    import torch

    import avex_tpu_torch
    from avex_tpu_torch.ops import attention_kernels as ak
    from chip_smoke import load_beats

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    split = [randn(128, 248, H * D).view(128, 248, H, D).permute(0, 2, 1, 3) for _ in range(3)]
    eat = randn(128, 513, 3 * H * D)
    q, k, v = (t.permute(0, 2, 1, 3) for t in eat.view(128, 513, 3, H, D).unbind(2))
    beats = randn(128, 248, 3 * H * D)
    bias, gate = randn(H, 248, 248), torch.rand(128, H, 248, device="cuda", generator=gen) + 1
    mae = randn(128, 513, 3 * 16 * 80)
    with torch.no_grad():
        times = {"K5": median_ms(lambda: ak.fused_qkv_attention(eat, H), 20),
                 "K4": median_ms(lambda: ak.gated_bias_attention(q, k, v, None), 20),
                 "K1": median_ms(lambda: ak.gated_bias_attention(*split, bias, gate), 20),
                 "K2": median_ms(lambda: ak.fused_qkv_gated_attention(beats, H, bias, gate), 20),
                 "K5@80": median_ms(lambda: ak.fused_qkv_attention(mae, 16), 20)}
    print(f"AB {CHECKOUT} fp32 " + " ".join(f"{name}={ms:.4f}" for name, ms in times.items()), flush=True)
    del split, eat, q, k, v, beats, bias, gate, mae
    torch.cuda.empty_cache()
    rates, paths = {}, {}
    for name, samples in (("beats", 5 * 16000), ("eat", 10 * 16000)):
        if name == "beats":  # the official config through a ModelSpec, as chip_smoke.py phase 5 builds it
            model = load_beats("float32", use_pallas=True)
        else:
            model = avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", random_weights=True,
                                              return_features_only=True, device="cuda", use_pallas=True,
                                              compute_dtype="float32")
            model.register_hooks_for_layers(["all"])
        wav = randn(128, samples) * 0.1
        seconds = []
        with torch.no_grad():
            for i in range(9):
                torch.cuda.synchronize()
                start = time.perf_counter()
                model.extract_embeddings(wav, aggregation="mean")
                torch.cuda.synchronize()
                if i:  # the first is the warm-up
                    seconds.append(time.perf_counter() - start)
            rates[name] = 128 / statistics.median(seconds)
            paths[name] = batch_path(model, wav, ak)
        del model, wav
        torch.cuda.empty_cache()
    print(f"AB-clips {CHECKOUT} " + " ".join(f"{name}={rate:.1f}" for name, rate in rates.items()), flush=True)
    for name, line in paths.items():
        print(f"AB-path {CHECKOUT} {name} {line}", flush=True)
    return 0


def main() -> int:
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if FP32:
        return fp32_main()
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
