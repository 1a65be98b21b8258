#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``avex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own:

1. card: require CUDA; print ``nvidia-smi``'s name and power limit;
2. build: compile every CUDA source of the port with ``nvcc`` (in parallel);
3. kernels: hold each kernel against its plain PyTorch twin at the shapes the
   main paths give it, in bf16 and fp32: the gated K1 and K2 at BEATs' shape
   (B=128, H=12, T=248, D=64), with and without the gate and with a
   key-padding mask; the bias-free K5 at EAT's shape (T=513) with and without
   a mask and at AVES's (T=249) with its frame mask, and K4 on the split views
   of EAT's projection. It times the kernel, the twin and one PyTorch library
   call (``scaled_dot_product_attention``, a yardstick the port never calls);
4. BEATs main path: full-width BEATs (12 layers, 768-d) through
   ``load_model`` with seeded random weights and ``use_pallas=True``,
   ``extract_embeddings`` over all 13 layers with mean pooling on batches of
   5 s clips, in bf16 and fp32, then with ``fused_qkv=True``;
5. EAT main path: the official ``esp_aves2_sl_eat_all_ssl_all`` entry
   (12 blocks, 768-d, T=513 tokens) on 10 s clips, ``use_pallas=True`` in
   bf16 and fp32, and the plain path;
6. AVES main path: ``aves_bio`` (12 layers, 768-d, T=249 frames) on 5 s clips
   with a padding mask on a third of them, the same runs.

Each main path checks shapes, finiteness, the kernel launch counts per
forward, the fp32 kernel path against the fp32 plain path, and prints clips/s.

It then prints one JSON line of per-kernel numbers (``launches`` counts the
main paths' runs; K4, which no main path reaches, adds
``kernel_phase_launches``) and, last, the device line
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
T_EAT = 513  # EAT: 10 s → 1024 frames → 8 x 64 patches, plus the CLS token
T_AVES = 249  # AVES: 5 s at 16 kHz, 320-sample hop
CLIP_SAMPLES = 5 * 16000
EAT_CLIP_SAMPLES = 10 * 16000
AVES_PAD_FROM = 3 * 16000  # a third of the AVES clips are padded from 3 s (frame 150)
N_BATCHES = 4
N_BATCHES_EAT_AVES = 3
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


def attention_bound_ms(dtype_name: str, gated: bool, padded: bool, seq: int = T) -> tuple:
    """Least time for one attention call at (B, H, seq, D) on the card: q, k,
    v read and out written once, the fp32 bias (gated) and gate read once, the
    mask read once; two matmuls of 2·seq·seq·D FLOPs per (batch, head)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * H * seq * D * elem
    nbytes += H * seq * seq * 4 + B * H * seq * 4 if gated else 0
    nbytes += B * seq if padded else 0
    flops = 4.0 * B * H * seq * seq * D
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


def phase_bias_free_kernels():
    """K5 and K4 against their twins at EAT's and AVES's shapes; returns
    per-kernel numbers for the JSON line and K4's launches (no model reaches
    K4 at full width: the kernel phase is where it runs)."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    ak.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        qkv = torch.randn(B, T_EAT, 3 * E, device="cuda", generator=gen).to(dtype)
        # _Block's split branch: [B, H, T, D] views of the one projection
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(B, T_EAT, 3, H, D).unbind(2))
        eat_mask = torch.zeros(B, T_EAT, dtype=torch.bool, device="cuda")
        eat_mask[1::3, 300:] = True
        eat_mask[2::7, 17:] = True
        aves_qkv = torch.randn(B, T_AVES, 3 * E, device="cuda", generator=gen).to(dtype)
        aves_q, aves_k, aves_v = (t.permute(0, 2, 1, 3) for t in aves_qkv.view(B, T_AVES, 3, H, D).unbind(2))
        aves_mask = torch.zeros(B, T_AVES, dtype=torch.bool, device="cuda")
        aves_mask[::3, 150:] = True
        cases = (
            # (kernel, shape label, seq, kernel call, twin, masks checked, mask timed, SDPA views)
            ("fused_qkv_attention", "EAT", T_EAT,
             lambda m: ak.fused_qkv_attention(qkv, H, m), lambda m: ak.fused_qkv_reference(qkv, H, m),
             (None, eat_mask), None, (q, k, v)),
            ("plain_attention", "EAT", T_EAT,
             lambda m: ak.gated_bias_attention(q, k, v, None, None, m),
             lambda m: ak.gated_bias_attention_reference(q, k, v, None, None, m),
             (None, eat_mask), None, (q, k, v)),
            ("fused_qkv_attention", "AVES", T_AVES,
             lambda m: ak.fused_qkv_attention(aves_qkv, H, m), lambda m: ak.fused_qkv_reference(aves_qkv, H, m),
             (aves_mask,), aves_mask, (aves_q, aves_k, aves_v)),
        )
        with torch.no_grad():
            for kname, shape, seq, run, twin, masks, timed_mask, views in cases:
                worst = 0.0
                for m in masks:
                    got, want = run(m), twin(m)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    rel = rel_l2(got, want)
                    worst = max(worst, err)
                    label = f"{kname} {shape} T={seq} {name} mask={m is not None}"
                    check(bool(torch.isfinite(got).all()), f"{label}: finite")
                    if dtype == torch.float32:
                        check(err <= FP32_ATOL, f"{label}: max|d|={err:.3e} <= {FP32_ATOL:g} (rel {rel:.3e})")
                    else:
                        check(rel <= BF16_REL_L2, f"{label}: rel L2={rel:.3e} <= {BF16_REL_L2:g} (max|d| {err:.3e})")

                ms = median_ms(lambda: run(timed_mask))
                plain_ms = median_ms(lambda: twin(timed_mask))
                keep = None if timed_mask is None else ~timed_mask[:, None, None, :]  # SDPA: True = attend
                library_ms = median_ms(lambda: F.scaled_dot_product_attention(*views, attn_mask=keep, scale=D**-0.5))
                bound, bound_by = attention_bound_ms(name, gated=False, padded=timed_mask is not None, seq=seq)
                print(
                    f"time {kname} {shape} T={seq} {name} (mask={timed_mask is not None}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
                    f"({bound / ms:.1%} of bound)"
                )
                results[(kname, shape, name)] = dict(
                    max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound, bound_by=bound_by,
                )
        del qkv, q, k, v, aves_qkv, aves_q, aves_k, aves_v, eat_mask, aves_mask
        torch.cuda.empty_cache()
    k4_launches = ak.LAUNCHES["plain_attention"]
    print(f"plain_attention (K4) launched {k4_launches} times in this phase")
    return results, k4_launches


def drive(model, label, expect, batches, n_emb, layers, pool, padding_mask=None):
    """Reset the counts, run warm-up + timed extraction, read the counts.

    ``pool(features, aux)`` gives the pooled final features compared across
    paths. Returns (first embeddings, pooled, counts, clips/s).
    """
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    ak.reset_launch_counts()
    first = model.extract_embeddings(batches[0], padding_mask=padding_mask, aggregation="mean")
    pooled = pool(*model.module(batches[0], padding_mask)).float()
    torch.cuda.synchronize()
    start = time.perf_counter()
    outs = [model.extract_embeddings(w, padding_mask=padding_mask, aggregation="mean") for w in batches]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = dict(ak.LAUNCHES)
    forwards = len(batches) + 2
    bsz = batches[0].shape[0]
    for emb in [first, *outs]:
        check(tuple(emb.shape) == (bsz, n_emb), f"{label}: embeddings {tuple(emb.shape)} == {(bsz, n_emb)}")
        check(bool(torch.isfinite(emb).all()), f"{label}: embeddings finite")
    for kname in counts:
        want = layers * forwards if kname == expect else 0
        check(counts[kname] == want,
              f"{label}: {kname} launched {counts[kname]} times == {want} ({layers} per forward x {forwards})")
    rate = bsz * len(batches) / elapsed
    print(f"{label}: {rate:.1f} clips/s (B={bsz}, {len(batches)} batches, {elapsed * 1e3:.1f} ms) "
          f"on {torch.cuda.get_device_name(0)}")
    return first, pooled, counts, rate


def compare_paths(label, kernel_pooled, kernel_emb, plain_pooled, plain_emb):
    r1, r2 = rel_l2(kernel_pooled, plain_pooled), rel_l2(kernel_emb, plain_emb)
    check(r1 <= PATH_REL and r2 <= PATH_REL,
          f"{label}: fp32 kernel path vs plain-attention path: pooled rel {r1:.3e}, "
          f"embeddings rel {r2:.3e} <= {PATH_REL:g}")


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

    def run(model, label, expect):
        return drive(model, label, expect, batches, n_emb, layers, lambda features, aux: features.mean(dim=1))

    with torch.no_grad():
        bf16 = load("bfloat16", use_pallas=True)
        emb16, pooled16, counts_split, rate16 = run(bf16, "main bf16 split", "gated_bias_attention")
        split_state = {k: v.float().cpu().numpy() for k, v in bf16.state_dict().items()}
        del bf16

        fp32 = load("float32", use_pallas=True)
        emb32, pooled32, _, rate32 = run(fp32, "main fp32 split", "gated_bias_attention")
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
        compare_paths("BEATs", pooled32, emb32, ref_pooled, ref_emb)

        plain16 = load("bfloat16", use_pallas=None)
        *_, rate_plain16 = run(plain16, "bf16 plain-attention path (use_pallas=None)", None)
        del plain16

        fused = load("bfloat16", use_pallas=True, fused_qkv=True)
        fused.load_state_dict(split_state, strict=True)  # the split model's weights, q|k|v concatenated
        emb_f, pooled_f, counts_fused, rate_fused = run(fused, "main bf16 fused_qkv", "fused_qkv_gated_attention")
        rf = rel_l2(pooled_f, pooled16)
        check(rf <= 2e-2, f"bf16 fused_qkv vs split, same weights: pooled rel {rf:.3e} <= 2e-2")
        del fused
    print(json.dumps({
        "model": "beats",
        "clips_per_s": {"bf16_split_kernel": rate16, "fp32_split_kernel": rate32,
                        "bf16_plain_attention": rate_plain16, "bf16_fused_qkv_kernel": rate_fused},
        "batch": B, "clip_seconds": CLIP_SAMPLES / 16000,
    }))
    return {"gated_bias_attention": counts_split["gated_bias_attention"],
            "fused_qkv_gated_attention": counts_fused["fused_qkv_gated_attention"]}


def bias_free_main_path(label, load, batches, padding_mask, pool, layers, width):
    """One bias-free model family through the public API: bf16 and fp32 on the
    K5 path, the fp32 plain path against the fp32 kernel path, and the bf16
    plain path; prints the clips/s of each run and returns K5's launches in
    the bf16 kernel run."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    n_emb = layers * width

    def run(model, what, expect):
        model.register_hooks_for_layers(["all"])
        return drive(model, f"{label} {what}", expect, batches, n_emb, layers, pool, padding_mask)

    with torch.no_grad():
        emb16, pooled16, counts, rate16 = run(load("bfloat16", True), "bf16 fused_qkv kernel", "fused_qkv_attention")
        emb32, pooled32, _, rate32 = run(load("float32", True), "fp32 fused_qkv kernel", "fused_qkv_attention")
        rel = rel_l2(pooled16, pooled32)
        print(f"{label} bf16 vs fp32 pooled features: rel L2 {rel:.3e}; {layers}-layer embeddings rel L2 "
              f"{rel_l2(emb16, emb32):.3e}")
        check(rel < 5e-2, f"{label} bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        plain32 = load("float32", None)
        plain32.register_hooks_for_layers(["all"])
        ak.reset_launch_counts()
        ref_pooled = pool(*plain32.module(batches[0], padding_mask)).float()
        ref_emb = plain32.extract_embeddings(batches[0], padding_mask=padding_mask, aggregation="mean")
        check(sum(ak.LAUNCHES.values()) == 0, f"{label} fp32 plain-attention path launches no kernel")
        del plain32
        compare_paths(label, pooled32, emb32, ref_pooled, ref_emb)
        *_, rate_plain16 = run(load("bfloat16", None), "bf16 plain-attention path (use_pallas=None)", None)
    torch.cuda.empty_cache()
    print(json.dumps({
        "model": label.lower(),
        "clips_per_s": {"bf16_fused_qkv_kernel": rate16, "fp32_fused_qkv_kernel": rate32,
                        "bf16_plain_attention": rate_plain16},
        "batch": B, "clip_seconds": batches[0].shape[1] / 16000, "bf16_fp32_pooled_rel_l2": rel,
    }))
    return counts["fused_qkv_attention"]


def phase_eat():
    """Full-width EAT extraction through the official registry entry."""
    import torch

    import avex_tpu_torch

    def load(dtype, use_pallas):
        return avex_tpu_torch.load_model(
            "esp_aves2_sl_eat_all_ssl_all", random_weights=True, return_features_only=True,
            device="cuda", use_pallas=use_pallas, compute_dtype=dtype,
        )

    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = [torch.randn(B, EAT_CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_EAT_AVES)]
    return bias_free_main_path("EAT", load, batches, None, lambda features, aux: aux["pooled"], 12, E)


def phase_aves():
    """Full-width AVES extraction, a third of the clips padded, through a ModelSpec."""
    import torch

    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models.beats import downsample_padding_mask

    def load(dtype, use_pallas):
        spec = ModelSpec(name="aves_bio", pretrained=False, compute_dtype=dtype)
        return avex_tpu_torch.load_model(
            spec, random_weights=True, return_features_only=True, device="cuda", use_pallas=use_pallas
        )

    def pool(features, aux):
        valid = (~aux["padding_mask"]).float()[..., None]
        return (features.float() * valid).sum(dim=1) / valid.sum(dim=1)

    gen = torch.Generator(device="cuda").manual_seed(4)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES_EAT_AVES)]
    mask = torch.zeros(B, CLIP_SAMPLES, dtype=torch.bool, device="cuda")
    mask[::3, AVES_PAD_FROM:] = True
    # The frame mask K5 receives: the fp32 kernel path can only agree with the
    # plain path (which adds the mask as a -inf bias) if the kernel honours it.
    frames = downsample_padding_mask(mask, T_AVES)
    rows, first = int(frames.any(dim=1).sum()), int(frames[0].int().argmax())
    check(rows == len(range(0, B, 3)) and first == 150,
          f"AVES frame mask: {rows} of {B} clips padded from frame {first} of {T_AVES}")
    return bias_free_main_path("AVES", load, batches, mask, pool, 12, E)


def main() -> int:
    start = time.perf_counter()
    phase_card()
    import torch

    phase_build()
    timings = phase_kernels()
    plain_timings, k4_launches = phase_bias_free_kernels()
    launches = phase_main_path()
    eat_launches = phase_eat()
    aves_launches = phase_aves()
    torch.cuda.synchronize()
    print(f"fused_qkv_attention (K5) launched {eat_launches} times on the EAT path and "
          f"{aves_launches} on the AVES path")
    launches["fused_qkv_attention"] = eat_launches + aves_launches
    # No main path reaches K4: every model's dh-64 projection takes K5, and K4
    # takes dh 64 only; drive() checks that each main-path run launched it 0
    # times. Its kernel-phase launches go under a key of their own.
    launches["plain_attention"] = 0

    # (kernel, line of the TPU kernel, timing at the main path's compute dtype, bf16)
    rows = (
        ("gated_bias_attention", "avex_tpu/ops/pallas_attention.py:126", timings[("gated_bias_attention", "bfloat16")]),
        ("fused_qkv_gated_attention", "avex_tpu/ops/pallas_attention.py:389",
         timings[("fused_qkv_gated_attention", "bfloat16")]),
        ("plain_attention", "avex_tpu/ops/pallas_attention.py:161", plain_timings[("plain_attention", "EAT", "bfloat16")]),
        ("fused_qkv_attention", "avex_tpu/ops/pallas_attention.py:344",
         plain_timings[("fused_qkv_attention", "EAT", "bfloat16")]),
    )
    kernels = []
    for kname, replaces, t in rows:
        kernels.append({
            "name": kname, "route": "cuda", "source": "avex_tpu_torch/ops/csrc/gated_attention.cu",
            "replaces": replaces, "launches": launches[kname], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if kname == "plain_attention":
            kernels[-1]["kernel_phase_launches"] = k4_launches
            check(k4_launches > 0, f"{kname} ran in the kernel phase (no main path reaches it)")
        else:
            check(launches[kname] > 0, f"{kname} ran on the main path")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s, kernel build included")
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
