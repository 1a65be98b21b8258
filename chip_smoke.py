#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``avex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own:

1. card: require CUDA; print ``nvidia-smi``'s name and power limit;
2. build: compile every CUDA source of the port with ``nvcc`` (in parallel);
3. kernels: hold each kernel against its plain PyTorch twin at the shapes the
   main path gives it (BEATs, B=128, H=12, T=248, D=64), in bf16 and fp32,
   with and without the gate and with a key-padding mask; time the kernel, the
   twin and one PyTorch library call (``scaled_dot_product_attention`` with
   the materialised ``gate*bias+pad`` mask, a yardstick the port never calls);
4. main path: full-width BEATs (12 layers, 768-d) through ``load_model`` with
   seeded random weights and ``use_pallas=True``, ``extract_embeddings`` over
   all 13 layers with mean pooling on batches of 5 s clips, in bf16 and fp32,
   then with ``fused_qkv=True``. It checks shapes, finiteness, the kernel
   launch counts per forward, agreement with the plain-attention path, and
   prints clips/s.

It then prints one JSON line of per-kernel numbers and, last, the device line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before that
line. Nothing of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

B, H, T, D = 128, 12, 248, 64  # BEATs: 5 s at 16 kHz → 31 x 8 patches; 768 / 12 heads
E = H * D
CLIP_SAMPLES = 5 * 16000
N_BATCHES = 4
TIMED_LAUNCHES = 20
# Device peaks of an H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s, and fp32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Kernel vs twin: fp32 max|Δ| — the online softmax adds the same terms in
# another order; bf16 relative L2 — the kernel rounds the unnormalised P to
# bf16 (the twin rounds the normalised one) and the output is rounded to bf16.
FP32_ATOL = 1e-4
BF16_REL_L2 = 5e-3
# Main path, fp32: the kernel path against the plain-attention path over 12
# layers with the same weights; sums in another order, compounded by depth.
PATH_REL = 1e-3
TPU_BF16_FP32_REL = 3.8e-3  # JAX package on a TPU v5e (BENCH_r05.json): a reference point only

FAILURES: list = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what)
    if not ok:
        FAILURES.append(what)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def median_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Median of ``n`` launches, each between two CUDA events, after two warm-ups."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def attention_bound_ms(dtype_name: str, gated: bool, padded: bool) -> tuple:
    """Least time for one gated attention call at (B, H, T, D) on the card:
    q, k, v read and out written once, the fp32 bias and gate read once, the
    mask read once; two matmuls of 2·T·T·D FLOPs per (batch, head)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * H * T * D * elem + H * T * T * 4
    nbytes += B * H * T * 4 if gated else 0
    nbytes += B * T if padded else 0
    flops = 4.0 * B * H * T * T * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one", file=sys.stderr)
        sys.exit(2)
    import avex_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")


def phase_build():
    from avex_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))  # one nvcc per source, all at once
    print(f"build: {len(sources)} source(s) in {time.perf_counter() - start:.2f} s: {sources}")
    for name, (seconds, log) in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: nvcc {seconds:.2f} s; " + " | ".join(regs))


def phase_kernels():
    """Each kernel against its twin; returns per-kernel numbers for the JSON line."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        # As the main path hands them over: split q/k/v are [B, H, T, D] views
        # of three [B, T, E] projections; the fused kernel reads [B, T, 3E].
        qkv = torch.randn(B, T, 3 * E, device="cuda", generator=gen).to(dtype)
        q, k, v = (
            torch.randn(B, T, E, device="cuda", generator=gen).to(dtype).view(B, T, H, D).permute(0, 2, 1, 3)
            for _ in range(3)
        )
        bias = torch.randn(H, T, T, device="cuda", generator=gen)
        gate = torch.rand(B, H, T, device="cuda", generator=gen) + 1.0  # BEATs gates lie in (1, 3)
        mask = torch.zeros(B, T, dtype=torch.bool, device="cuda")
        mask[1::3, 200:] = True
        mask[2::7, 17:] = True
        qs, ks, vs = (t.permute(0, 2, 1, 3) for t in qkv.view(B, T, 3, H, D).unbind(2))

        with torch.no_grad():
            for kname, run, twin in (
                (
                    "gated_bias_attention",
                    lambda g, m: ak.gated_bias_attention(q, k, v, bias, g, m),
                    lambda g, m: ak.gated_bias_attention_reference(q, k, v, bias, g, m),
                ),
                (
                    "fused_qkv_gated_attention",
                    lambda g, m: ak.fused_qkv_gated_attention(qkv, H, bias, g, m),
                    lambda g, m: ak.fused_qkv_gated_reference(qkv, H, bias, g, m),
                ),
            ):
                worst = 0.0
                for g in (gate, None):
                    for m in (None, mask):
                        got, want = run(g, m), twin(g, m)
                        torch.cuda.synchronize()
                        err = float((got.float() - want.float()).abs().max())
                        rel = rel_l2(got, want)
                        worst = max(worst, err)
                        label = f"{kname} {name} gate={g is not None} mask={m is not None}"
                        check(bool(torch.isfinite(got).all()), f"{label}: finite")
                        if dtype == torch.float32:
                            check(err <= FP32_ATOL, f"{label}: max|d|={err:.3e} <= {FP32_ATOL:g} (rel {rel:.3e})")
                        else:
                            check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")

                ms = median_ms(lambda: run(gate, None))
                plain_ms = median_ms(lambda: twin(gate, None))
                sdpa_q, sdpa_k, sdpa_v = (q, k, v) if kname == "gated_bias_attention" else (qs, ks, vs)
                attn_mask = (gate[..., None] * bias[None]).to(dtype)  # materialised outside the timing
                library_ms = median_ms(
                    lambda: F.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v, attn_mask=attn_mask, scale=D**-0.5)
                )
                bound, bound_by = attention_bound_ms(name, gated=True, padded=False)
                print(
                    f"time {kname} {name} (gate, no mask): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"sdpa {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
                    f"({bound / ms:.1%} of bound)"
                )
                results[(kname, name)] = dict(
                    max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound, bound_by=bound_by,
                )
        del qkv, q, k, v, qs, ks, vs, bias, gate, mask
        torch.cuda.empty_cache()
    return results


def phase_main_path():
    """Full-width BEATs extraction through the public API; returns launch counts."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.ops import attention_kernels as ak

    official = OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"]
    layers = official["encoder_layers"]
    n_emb = (layers + 1) * official["encoder_embed_dim"]

    def load(dtype, **init):
        spec = ModelSpec(
            name="beats", pretrained=False, compute_dtype=dtype,
            init_config=dict(official, **init),
        )
        model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
        model.register_hooks_for_layers(["all"])
        return model

    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES)]

    def drive(model, label, expect):
        """Reset the counts, run warm-up + timed extraction, read the counts."""
        ak.reset_launch_counts()
        first = model.extract_embeddings(batches[0], aggregation="mean")
        pooled = model(batches[0]).float().mean(dim=1)  # final features, time-pooled
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs = [model.extract_embeddings(w, aggregation="mean") for w in batches]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        counts = dict(ak.LAUNCHES)
        forwards = len(batches) + 2
        for emb in [first, *outs]:
            check(tuple(emb.shape) == (B, n_emb), f"{label}: embeddings {tuple(emb.shape)} == {(B, n_emb)}")
            check(bool(torch.isfinite(emb).all()), f"{label}: embeddings finite")
        for kname in counts:
            want = layers * forwards if kname == expect else 0
            check(counts[kname] == want,
                  f"{label}: {kname} launched {counts[kname]} times == {want} ({layers} per forward x {forwards})")
        rate = B * len(batches) / elapsed
        print(f"{label}: {rate:.1f} clips/s (B={B}, {len(batches)} batches, {elapsed * 1e3:.1f} ms) "
              f"on {torch.cuda.get_device_name(0)}")
        return first, pooled, counts, rate

    with torch.no_grad():
        bf16 = load("bfloat16", use_pallas=True)
        emb16, pooled16, counts_split, rate16 = drive(bf16, "main bf16 split", "gated_bias_attention")
        split_state = {k: v.float().cpu().numpy() for k, v in bf16.state_dict().items()}
        del bf16

        fp32 = load("float32", use_pallas=True)
        emb32, pooled32, _, rate32 = drive(fp32, "main fp32 split", "gated_bias_attention")
        del fp32
        rel = rel_l2(pooled16, pooled32)
        print(f"bf16 vs fp32 pooled features: rel L2 {rel:.3e} (JAX package on a TPU v5e: {TPU_BF16_FP32_REL:g}, "
              f"a reference point, not a target); 13-layer embeddings rel L2 {rel_l2(emb16, emb32):.3e}")
        check(rel < 5e-2, f"bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        plain32 = load("float32", use_pallas=False)
        ak.reset_launch_counts()
        ref_pooled = plain32(batches[0]).float().mean(dim=1)
        ref_emb = plain32.extract_embeddings(batches[0], aggregation="mean")
        check(sum(ak.LAUNCHES.values()) == 0, "fp32 plain-attention path launches no kernel")
        del plain32
        r1, r2 = rel_l2(pooled32, ref_pooled), rel_l2(emb32, ref_emb)
        check(r1 <= PATH_REL and r2 <= PATH_REL,
              f"fp32 kernel path vs plain-attention path: pooled rel {r1:.3e}, embeddings rel {r2:.3e} <= {PATH_REL:g}")

        plain16 = load("bfloat16", use_pallas=None)
        *_, rate_plain16 = drive(plain16, "bf16 plain-attention path (use_pallas=None)", None)
        del plain16

        fused = load("bfloat16", use_pallas=True, fused_qkv=True)
        fused.load_state_dict(split_state, strict=True)  # the split model's weights, q|k|v concatenated
        emb_f, pooled_f, counts_fused, rate_fused = drive(fused, "main bf16 fused_qkv", "fused_qkv_gated_attention")
        rf = rel_l2(pooled_f, pooled16)
        check(rf <= 2e-2, f"bf16 fused_qkv vs split, same weights: pooled rel {rf:.3e} <= 2e-2")
        del fused
    print(json.dumps({
        "clips_per_s": {"bf16_split_kernel": rate16, "fp32_split_kernel": rate32,
                        "bf16_plain_attention": rate_plain16, "bf16_fused_qkv_kernel": rate_fused},
        "batch": B, "clip_seconds": CLIP_SAMPLES / 16000,
    }))
    return {"gated_bias_attention": counts_split["gated_bias_attention"],
            "fused_qkv_gated_attention": counts_fused["fused_qkv_gated_attention"]}


def main() -> int:
    phase_card()
    import torch

    phase_build()
    timings = phase_kernels()
    launches = phase_main_path()
    torch.cuda.synchronize()

    sources = {"gated_bias_attention": "avex_tpu/ops/pallas_attention.py:126",
               "fused_qkv_gated_attention": "avex_tpu/ops/pallas_attention.py:389"}
    kernels = []
    for kname, replaces in sources.items():
        t = timings[(kname, "bfloat16")]  # the main path's compute dtype
        kernels.append({
            "name": kname, "route": "cuda", "source": "avex_tpu_torch/ops/csrc/gated_attention.cu",
            "replaces": replaces, "launches": launches[kname], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        check(launches[kname] > 0, f"{kname} ran on the main path")
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
