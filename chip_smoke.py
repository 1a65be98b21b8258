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
4. int8 kernels: K7 (``int8_dynamic_dense``) against its twin at BEATs'
   three (K, N) pairs, at M = 31,744 (B=128) and 248 (one clip), with x in
   bf16 and fp32, with and without the bias (fp32 and bf16 within 1 ulp,
   target 0); K8 (``int8_matmul``) exactly equal to its twin at
   ``scripts/bench_int8_matmul.py``'s shape. Times the kernel, the twin and a
   yardstick (bf16 ``F.linear``, what the float model runs, for K7;
   ``torch._int_mm`` for K8);
5. BEATs main path: full-width BEATs (12 layers, 768-d) through
   ``load_model`` with seeded random weights and ``use_pallas=True``,
   ``extract_embeddings`` over all 13 layers with mean pooling on batches of
   5 s clips, in bf16 and fp32, then with ``fused_qkv=True``;
6. int8 BEATs main path: the same model through
   ``load_model(quantization="int8")`` in bf16 (K7 72 and K1 12 launches per
   forward), held to the float model with the same weights; every int8 layer
   held to the K7 twin on its own input inside the model (bf16 B=128 and fp32
   B=2); the fp32 int8 model against the same model on the CPU;
7. EAT main path: the official ``esp_aves2_sl_eat_all_ssl_all`` entry
   (12 blocks, 768-d, T=513 tokens) on 10 s clips, ``use_pallas=True`` in
   bf16 and fp32, and the plain path;
8. AVES main path: ``aves_bio`` (12 layers, 768-d, T=249 frames) on 5 s clips
   with a padding mask on a third of them, the same runs;
9. serving: the int8 and the float bf16 BEATs in one ``ServicePool`` behind
   ``AvexHTTPServer`` on an ephemeral port (buckets up to 32, warm-up of 1
   and 32); 8 producer threads submit 96 clips to each model (3 s, 7 s and
   8 kHz ones among them) and two requests go over HTTP (.npy, WAV). Every
   row is held to its clip extracted alone; prints requests/s and p50/p99
   latency per model.

Each main path checks shapes, finiteness, the kernel launch counts per
forward (every kernel of the port: those the path runs, and 0 for the rest),
the fp32 kernel path against the fp32 plain path, and prints clips/s.

It then prints one JSON line of per-kernel numbers (``launches`` counts the
main paths' runs; K4 and K8, which no main path reaches, add
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
# tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, dense int8 OP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_INT8_OPS = 1979e12
# Int8 BEATs: the encoder's dense layers as (K, N), and launches per layer.
ENCODER_LAYERS = 12
INT8_SHAPES = {"q/k/v/out_proj": (E, E), "fc1": (E, 4 * E), "fc2": (4 * E, E)}
INT8_PER_LAYER = {"q/k/v/out_proj": 4, "fc1": 1, "fc2": 1}
INT8_PER_FORWARD = ENCODER_LAYERS * sum(INT8_PER_LAYER.values())  # 72
M_FULL, M_ONE = B * T, T  # rows of a B=128 batch and of one clip (serving bucket 1)
# K7 vs twin: the same int8 activations and int32 sums, rounded at the same
# steps; the target is 0 and the limit 1 unit in the last place (fp32 and bf16).
K7_MAX_ULPS = 1
INT8_FLOAT_REL = 5e-2  # int8 vs float pooled: the JAX package's test bound (test_quant.py:137)
# fp32 int8 on the card vs the same model on the CPU. Every int8 layer is
# held to its twin on its own inputs from the model first (max|d| 0). End to
# end, the float parts sum in another order on the CPU, and an activation
# that lands that close to a rounding boundary takes the neighbouring int8
# level on one side only; 12 random-weight layers carry those flips to ~2e-3
# of the pooled features. The phase prints the flips and the float model's
# own card-vs-CPU gap. 5e-3 stays well below the int8-vs-float gap.
INT8_CARD_CPU_REL = 5e-3
# Serving: 8 producer threads, 96 clips for each model; a served row against
# the clip alone, bf16 (cuBLAS may pick another algorithm for another M).
N_PRODUCERS, N_SERVED = 8, 96
SERVE_REL = 1e-2
SERVE_TIMEOUT = 300
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


def reset_counts() -> None:
    """Set the launch count of every kernel of the port to 0."""
    from avex_tpu_torch.ops import attention_kernels as ak
    from avex_tpu_torch.ops import int8_kernels as ik

    ak.reset_launch_counts()
    ik.reset_launch_counts()


def read_counts() -> dict:
    """Launches of every kernel of the port since the last reset_counts()."""
    from avex_tpu_torch.ops import attention_kernels as ak
    from avex_tpu_torch.ops import int8_kernels as ik

    return {**ak.LAUNCHES, **ik.LAUNCHES}


def drive(model, label, expect, batches, n_emb, pool, padding_mask=None):
    """Reset the counts, run warm-up + timed extraction, read the counts.

    ``expect`` maps each kernel the path must launch to its launches per
    forward; every other kernel must launch 0 times. ``pool(features, aux)``
    gives the pooled final features compared across paths. Returns (first
    embeddings, pooled, counts, clips/s).
    """
    import torch

    reset_counts()
    first = model.extract_embeddings(batches[0], padding_mask=padding_mask, aggregation="mean")
    pooled = pool(*model.module(batches[0], padding_mask)).float()
    torch.cuda.synchronize()
    start = time.perf_counter()
    outs = [model.extract_embeddings(w, padding_mask=padding_mask, aggregation="mean") for w in batches]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = read_counts()
    forwards = len(batches) + 2
    bsz = batches[0].shape[0]
    for emb in [first, *outs]:
        check(tuple(emb.shape) == (bsz, n_emb), f"{label}: embeddings {tuple(emb.shape)} == {(bsz, n_emb)}")
        check(bool(torch.isfinite(emb).all()), f"{label}: embeddings finite")
    for kname in counts:
        per_forward = expect.get(kname, 0)
        check(counts[kname] == per_forward * forwards,
              f"{label}: {kname} launched {counts[kname]} times == {per_forward * forwards} "
              f"({per_forward} per forward x {forwards})")
    rate = bsz * len(batches) / elapsed
    print(f"{label}: {rate:.1f} clips/s (B={bsz}, {len(batches)} batches, {elapsed * 1e3:.1f} ms) "
          f"on {torch.cuda.get_device_name(0)}")
    return first, pooled, counts, rate


def compare_paths(label, kernel_pooled, kernel_emb, plain_pooled, plain_emb):
    r1, r2 = rel_l2(kernel_pooled, plain_pooled), rel_l2(kernel_emb, plain_emb)
    check(r1 <= PATH_REL and r2 <= PATH_REL,
          f"{label}: fp32 kernel path vs plain-attention path: pooled rel {r1:.3e}, "
          f"embeddings rel {r2:.3e} <= {PATH_REL:g}")


def beats_config() -> dict:
    """The official ``esp_aves2_sl_beats_all`` init config (12 layers, 768-d)."""
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS

    return dict(OFFICIAL_MODELS["esp_aves2_sl_beats_all"]["model_spec"]["init_config"])


def load_beats(dtype, quantization=None, **init):
    """Full-width BEATs through ``load_model`` on the card, seeded random
    weights (the same for every call), every layer selected."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec

    spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype, init_config=dict(beats_config(), **init))
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda",
                                      quantization=quantization)
    model.register_hooks_for_layers(["all"])
    return model


def phase_main_path():
    """Full-width BEATs extraction through the public API; returns launch counts."""
    import torch

    official = beats_config()
    layers = official["encoder_layers"]
    n_emb = (layers + 1) * official["encoder_embed_dim"]

    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES)]

    def run(model, label, kernel):
        expect = {kernel: layers} if kernel else {}
        return drive(model, label, expect, batches, n_emb, lambda features, aux: features.mean(dim=1))

    with torch.no_grad():
        bf16 = load_beats("bfloat16", use_pallas=True)
        emb16, pooled16, counts_split, rate16 = run(bf16, "main bf16 split", "gated_bias_attention")
        split_state = {k: v.float().cpu().numpy() for k, v in bf16.state_dict().items()}
        del bf16

        fp32 = load_beats("float32", use_pallas=True)
        emb32, pooled32, _, rate32 = run(fp32, "main fp32 split", "gated_bias_attention")
        del fp32
        rel = rel_l2(pooled16, pooled32)
        print(f"bf16 vs fp32 pooled features: rel L2 {rel:.3e} (JAX package on a TPU v5e: {TPU_BF16_FP32_REL:g}, "
              f"a reference point, not a target); 13-layer embeddings rel L2 {rel_l2(emb16, emb32):.3e}")
        check(rel < 5e-2, f"bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        plain32 = load_beats("float32", use_pallas=False)
        reset_counts()
        ref_pooled = plain32(batches[0]).float().mean(dim=1)
        ref_emb = plain32.extract_embeddings(batches[0], aggregation="mean")
        check(sum(read_counts().values()) == 0, "fp32 plain-attention path launches no kernel")
        del plain32
        compare_paths("BEATs", pooled32, emb32, ref_pooled, ref_emb)

        plain16 = load_beats("bfloat16", use_pallas=None)
        *_, rate_plain16 = run(plain16, "bf16 plain-attention path (use_pallas=None)", None)
        del plain16

        fused = load_beats("bfloat16", use_pallas=True, fused_qkv=True)
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

    n_emb = layers * width

    def run(model, what, kernel):
        model.register_hooks_for_layers(["all"])
        expect = {kernel: layers} if kernel else {}
        return drive(model, f"{label} {what}", expect, batches, n_emb, pool, padding_mask)

    with torch.no_grad():
        emb16, pooled16, counts, rate16 = run(load("bfloat16", True), "bf16 fused_qkv kernel", "fused_qkv_attention")
        emb32, pooled32, _, rate32 = run(load("float32", True), "fp32 fused_qkv kernel", "fused_qkv_attention")
        rel = rel_l2(pooled16, pooled32)
        print(f"{label} bf16 vs fp32 pooled features: rel L2 {rel:.3e}; {layers}-layer embeddings rel L2 "
              f"{rel_l2(emb16, emb32):.3e}")
        check(rel < 5e-2, f"{label} bf16 vs fp32 pooled rel L2 {rel:.3e} < 5e-2")

        plain32 = load("float32", None)
        plain32.register_hooks_for_layers(["all"])
        reset_counts()
        ref_pooled = pool(*plain32.module(batches[0], padding_mask)).float()
        ref_emb = plain32.extract_embeddings(batches[0], padding_mask=padding_mask, aggregation="mean")
        check(sum(read_counts().values()) == 0, f"{label} fp32 plain-attention path launches no kernel")
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


def max_ulps(got, want, mantissa_bits: int) -> float:
    """Largest |got - want| in units of the last place of ``want`` (24
    significand bits for float32, 8 for bfloat16)."""
    import torch

    g, w = got.double(), want.double()
    _, exponent = torch.frexp(w.abs().clamp_min(1e-30))
    ulp = torch.ldexp(torch.ones_like(w), exponent - mantissa_bits)
    return float(((g - w).abs() / ulp).max())


def int8_bound_ms(m: int, k: int, n: int, x_bytes: int, out_bytes: int, bias: bool) -> tuple:
    """Least time for one int8 dense on the card: x, the int8 weight, its
    scales (and bias) read once, the output written once; 2·M·K·N int8
    operations at the dense int8 tensor-core rate."""
    nbytes = m * k * x_bytes + n * k + n * 4 * (2 if bias else 1) + m * n * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_int8_kernels():
    """K7 and K8 against their twins at BEATs' shapes; returns the numbers of
    the JSON line and K8's launches (no model reaches K8: the kernel phase is
    where it runs)."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import int8_kernels as ik
    from avex_tpu_torch.quant import quantize_kernel

    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_counts()
    worst = {"bfloat16": 0.0, "float32": 0.0}
    timed = {}
    with torch.no_grad():
        for name, (k, n) in INT8_SHAPES.items():
            weight = torch.randn(n, k, device="cuda", generator=gen) / k**0.5
            wq, scale = quantize_kernel(weight)
            bias = torch.randn(n, device="cuda", generator=gen) * 0.02
            for m in (M_FULL, M_ONE):
                for dtype in (torch.bfloat16, torch.float32):
                    dname = str(dtype).split(".")[1]
                    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
                    x[m // 3] = 0.0  # an all-zero row: the 1e-8 scale guard
                    for b in (None, bias):
                        got = ik.int8_dynamic_dense(x, wq, scale, b)
                        want = ik.int8_dynamic_dense_reference(x, wq, scale, b)
                        torch.cuda.synchronize()
                        err = float((got.float() - want.float()).abs().max())
                        ulps = max_ulps(got, want, 24 if dtype == torch.float32 else 8)
                        worst[dname] = max(worst[dname], err)
                        check(bool(torch.isfinite(got).all()) and got.dtype == dtype and got.shape == (m, n),
                              f"int8_dynamic_dense {name} M={m} {dname} bias={b is not None}: finite, {dtype}")
                        check(ulps <= K7_MAX_ULPS,
                              f"int8_dynamic_dense {name} M={m} {dname} bias={b is not None}: "
                              f"max|d|={err:.3e}, {ulps:g} ulp <= {K7_MAX_ULPS} (target 0)")
                    if dtype == torch.bfloat16:  # the model's call: bf16 x and out, with the bias
                        w16, b16 = weight.to(dtype), bias.to(dtype)
                        bound, bound_by = int8_bound_ms(m, k, n, 2, 2, bias=True)
                        timed[(name, m)] = dict(
                            ms=median_ms(lambda: ik.int8_dynamic_dense(x, wq, scale, bias)),
                            plain_ms=median_ms(lambda: ik.int8_dynamic_dense_reference(x, wq, scale, bias)),
                            library_ms=median_ms(lambda: F.linear(x, w16, b16)),
                            bound_ms=bound, bound_by=bound_by,
                        )
                        t = timed[(name, m)]
                        print(f"time int8_dynamic_dense {name} (K={k}, N={n}) M={m} bf16: kernel {t['ms']:.4f} ms "
                              f"({2 * m * k * n / t['ms'] / 1e9:.1f} TOP/s), plain {t['plain_ms']:.4f} ms, "
                              f"bf16 F.linear {t['library_ms']:.4f} ms, bound {bound:.4f} ms by {bound_by} "
                              f"({bound / t['ms']:.1%} of bound)")
                    del x
            del weight, wq, scale, bias
        # the 72 launches of one B=128 forward, and the bf16 gemms they replace
        forward_ms, library_forward = (
            ENCODER_LAYERS * sum(INT8_PER_LAYER[name] * timed[(name, M_FULL)][key] for name in INT8_SHAPES)
            for key in ("ms", "library_ms")
        )
        print(f"int8_dynamic_dense: the {INT8_PER_FORWARD} launches of a B={B} forward sum to {forward_ms:.3f} ms; "
              f"the bf16 F.linear calls they replace, {library_forward:.3f} ms")

        # K8 at scripts/bench_int8_matmul.py's shape, B as [K, N]
        k, n = INT8_SHAPES["fc1"]
        xq = torch.randint(-127, 128, (M_FULL, k), device="cuda", dtype=torch.int8, generator=gen)
        wq = torch.randint(-127, 128, (k, n), device="cuda", dtype=torch.int8, generator=gen)
        got, want = ik.int8_matmul(xq, wq), ik.int8_matmul_reference(xq, wq)
        torch.cuda.synchronize()
        k8_err = float((got.double() - want.double()).abs().max())
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"int8_matmul M={M_FULL} K={k} N={n}: exactly the twin's (max|d| {k8_err:g})")
        nbytes = M_FULL * k + k * n + M_FULL * n * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * M_FULL * k * n / PEAK_INT8_OPS * 1e3
        k8 = dict(
            max_abs_err=k8_err, ms=median_ms(lambda: ik.int8_matmul(xq, wq)),
            plain_ms=median_ms(lambda: ik.int8_matmul_reference(xq, wq)),
            library_ms=median_ms(lambda: torch._int_mm(xq, wq)),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        print(f"time int8_matmul M={M_FULL} K={k} N={n}: kernel {k8['ms']:.4f} ms "
              f"({2 * M_FULL * k * n / k8['ms'] / 1e9:.1f} TOP/s), plain {k8['plain_ms']:.4f} ms, "
              f"torch._int_mm {k8['library_ms']:.4f} ms, bound {k8['bound_ms']:.4f} ms by {k8['bound_by']}")
        del xq, wq, got, want
    torch.cuda.empty_cache()
    k8_launches = read_counts()["int8_matmul"]
    print(f"int8_matmul (K8) launched {k8_launches} times in this phase")
    k7 = dict(timed[("fc1", M_FULL)], max_abs_err=max(worst.values()))
    print(json.dumps({"int8_dense_ms": {f"{name} M={m}": t["ms"] for (name, m), t in timed.items()},
                      "bf16_linear_ms": {f"{name} M={m}": t["library_ms"] for (name, m), t in timed.items()},
                      "k7_forward_ms": forward_ms, "bf16_linear_forward_ms": library_forward,
                      "k7_max_abs_err": worst}))
    return k7, k8, k8_launches


def int8_layers_exact(model, x) -> tuple:
    """Run ``model`` on ``x`` and hold every Int8Linear's output to the K7
    twin on the same input. Returns (layers checked, worst max|d|)."""
    import torch

    from avex_tpu_torch.ops import int8_kernels as ik
    from avex_tpu_torch.quant import Int8Linear

    seen = []

    def hook(layer, inputs, output):
        want = ik.int8_dynamic_dense_reference(inputs[0], layer.weight_q, layer.weight_scale, layer.bias,
                                               out_dtype=layer.dtype)
        seen.append(float((output.float() - want.float()).abs().max()))

    handles = [m.register_forward_hook(hook) for m in model.module.modules() if isinstance(m, Int8Linear)]
    try:
        with torch.no_grad():
            model.module(x)
    finally:
        for h in handles:
            h.remove()
    return len(seen), max(seen)


def int8_levels(model, x) -> tuple:
    """Run ``model`` on ``x``; returns its pooled final features and the int8
    activation levels that each Int8Linear's input quantized to, on the host,
    in call order."""
    import torch

    from avex_tpu_torch.ops import int8_kernels as ik
    from avex_tpu_torch.quant import Int8Linear

    levels = []

    def hook(layer, inputs):
        levels.append(ik.quantize_rows(inputs[0])[0].to(torch.int8).cpu())

    handles = [m.register_forward_pre_hook(hook) for m in model.module.modules() if isinstance(m, Int8Linear)]
    try:
        with torch.no_grad():
            pooled = model.module(x)[0].mean(dim=1).float().cpu()
    finally:
        for h in handles:
            h.remove()
    return pooled, levels


def phase_int8_main_path():
    """Int8 BEATs through ``load_model(quantization="int8")``: launch counts,
    quality against the float model with the same weights and against the
    same int8 model on the CPU; returns K7's launches in the bf16 run."""
    import torch

    official = beats_config()
    layers = official["encoder_layers"]
    n_emb = (layers + 1) * official["encoder_embed_dim"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    batches = [torch.randn(B, CLIP_SAMPLES, device="cuda", generator=gen) * 0.1 for _ in range(N_BATCHES)]

    def run(model, label, expect):
        return drive(model, label, expect, batches, n_emb, lambda features, aux: features.mean(dim=1))

    with torch.no_grad():
        float16 = load_beats("bfloat16", use_pallas=True)
        _, pooled_f, _, rate_f = run(float16, "int8 phase: float bf16 (same weights)", {"gated_bias_attention": layers})
        del float16
        int8 = load_beats("bfloat16", quantization="int8", use_pallas=True)
        _, pooled_q, counts, rate_q = run(int8, "main int8 bf16",
                                          {"int8_dynamic_dense": INT8_PER_FORWARD, "gated_bias_attention": layers})
        n, worst = int8_layers_exact(int8, batches[0])
        check(n == INT8_PER_FORWARD and worst == 0.0,
              f"int8 bf16 model, B={B}: each of its {n} int8 layers equals the K7 twin on its own input "
              f"(max|d| {worst:g})")
        del int8
        rel = rel_l2(pooled_q, pooled_f)
        check(rel < INT8_FLOAT_REL, f"int8 vs float bf16, same weights: pooled rel L2 {rel:.3e} < {INT8_FLOAT_REL:g}")

        # The fp32 int8 model on the card (K7, K1) and the same model moved to
        # the CPU (their plain twins), on two clips.
        int8_32 = load_beats("float32", quantization="int8", use_pallas=True)
        small = batches[0][:2]
        n, worst = int8_layers_exact(int8_32, small)
        check(n == INT8_PER_FORWARD and worst == 0.0,
              f"int8 fp32 model, B=2: each of its {n} int8 layers equals the K7 twin on its own input "
              f"(max|d| {worst:g})")
        card_pooled, card_levels = int8_levels(int8_32, small)
        card_emb = int8_32.extract_embeddings(small, aggregation="mean").float().cpu()
        int8_32.to("cpu")
        host_pooled, host_levels = int8_levels(int8_32, small.cpu())
        host_emb = int8_32.extract_embeddings(small.cpu(), aggregation="mean").float()
        del int8_32
        r1, r2 = rel_l2(card_pooled, host_pooled), rel_l2(card_emb, host_emb)
        check(r1 <= INT8_CARD_CPU_REL and r2 <= INT8_CARD_CPU_REL,
              f"int8 fp32 on the card vs the same model on the CPU (twins), B=2: pooled rel {r1:.3e}, "
              f"embeddings rel {r2:.3e} <= {INT8_CARD_CPU_REL:g}")
        # Where that gap comes from: the int8 levels the card and the CPU give
        # the same layer's input, and the float model alone, card vs CPU.
        flips = [int((a != b).sum()) for a, b in zip(card_levels, host_levels)]
        step = max(int((a.int() - b.int()).abs().max()) for a, b in zip(card_levels, host_levels))
        sizes = [a.numel() for a in card_levels]
        per = sum(INT8_PER_LAYER.values())
        per_layer = [sum(flips[i:i + per]) for i in range(0, len(flips), per)]
        del card_levels, host_levels
        float32 = load_beats("float32", use_pallas=True)
        float_card = float32.module(small)[0].mean(dim=1).float().cpu()
        float32.to("cpu")
        float_host = float32.module(small.cpu())[0].mean(dim=1).float()
        del float32
        r_float = rel_l2(float_card, float_host)
        print(f"int8 fp32, card vs CPU, B=2: {sum(flips)} of {sum(sizes)} int8 activations take another level "
              f"(largest step {step}), {flips[0]} of {sizes[0]} at the first int8 layer; per encoder layer "
              f"{per_layer}")
        check(r_float <= PATH_REL, f"float fp32 on the card vs the same model on the CPU, B=2: pooled rel "
                                   f"{r_float:.3e} <= {PATH_REL:g}")
    torch.cuda.empty_cache()
    print(f"int8 BEATs bf16: {rate_q:.1f} clips/s vs float bf16 {rate_f:.1f} clips/s (B={B}, same weights)")
    print(json.dumps({
        "model": "beats_int8",
        "clips_per_s": {"bf16_int8_kernel": rate_q, "bf16_float_kernel": rate_f},
        "int8_vs_float_pooled_rel_l2": rel, "card_vs_cpu_fp32_rel": [r1, r2],
        "card_vs_cpu_int8_flips": sum(flips), "int8_activations": sum(sizes),
        "card_vs_cpu_fp32_float_rel": r_float,
        "batch": B, "clip_seconds": CLIP_SAMPLES / 16000,
    }))
    return counts["int8_dynamic_dense"]


def phase_serving():
    """The int8 and the float bf16 BEATs in one ServicePool behind the HTTP
    server: 8 producer threads, 96 clips each model, 2 HTTP requests; every
    row against the clip extracted alone."""
    import http.client
    import io
    import threading

    import numpy as np
    import torch
    from scipy.io import wavfile

    from avex_tpu_torch._native import decode_audio_bytes, resample
    from avex_tpu_torch.ops.audio import pad_or_window_np
    from avex_tpu_torch.serving import AvexHTTPServer, ServiceConfig, ServicePool

    rng = np.random.default_rng(7)
    sr = 16000

    def clip(i):
        """Most clips are 5 s at 16 kHz; every 8th is 3 s (padded), 7 s
        (center-cropped) or 5 s at 8 kHz (resampled)."""
        kind = i % 8
        seconds, rate = {1: (3, sr), 2: (7, sr), 3: (5, 8000)}.get(kind, (5, sr))
        return (rng.standard_normal(seconds * rate) * 0.1).astype(np.float32), rate

    clips = [clip(i) for i in range(N_SERVED)]
    # The int8 model first: the pool's default, served on the bare routes.
    models = {"int8": load_beats("bfloat16", quantization="int8", use_pallas=True),
              "float": load_beats("bfloat16", use_pallas=True)}
    config = ServiceConfig(clip_seconds=CLIP_SAMPLES / sr, max_batch=32, max_wait_ms=10, layers=["all"])
    pool = ServicePool.from_models(models, config=config)
    server = AvexHTTPServer(pool, port=0, request_timeout=SERVE_TIMEOUT).start()
    try:
        start = time.perf_counter()
        pool.warmup(buckets=[1, 32], timeout=SERVE_TIMEOUT)
        print(f"serving: warm-up of buckets 1 and 32 for both models {time.perf_counter() - start:.2f} s")
        resample(clips[3][0], 8000, sr)  # the first call builds the native library
        t0 = time.perf_counter()
        resample(clips[3][0], 8000, sr)
        resample_ms = (time.perf_counter() - t0) * 1e3
        print(f"serving: host resampling of one 5 s clip from 8 kHz: {resample_ms:.2f} ms (on the submitting thread)")
        forward_ms = {}
        for name, model in models.items():  # what the batcher thread runs per batch, alone
            for bucket in (1, 32):
                clips_in, masks_in = np.zeros((bucket, CLIP_SAMPLES), np.float32), np.zeros((bucket, CLIP_SAMPLES), bool)
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        model.extract_embeddings(clips_in, padding_mask=masks_in, aggregation="mean").float().cpu()
                    times.append((time.perf_counter() - t0) * 1e3)
                forward_ms[(name, bucket)] = statistics.median(times)
            print(f"serving {name}: one bucket-1 batch {forward_ms[(name, 1)]:.2f} ms, one bucket-32 batch "
                  f"{forward_ms[(name, 32)]:.2f} ms (host clock, numpy in, rows out; median of 5)")
        rows = {name: [None] * len(clips) for name in models}
        latency = {name: [] for name in models}
        lock = threading.Lock()

        def producer(worker):
            # A contiguous share of the clips: each producer sends the mix
            # (with every 8th index a resampled clip) as a client would.
            futures = []
            share = len(clips) // N_PRODUCERS
            for i in range(worker * share, (worker + 1) * share):
                wav, rate = clips[i]
                for name in models:
                    t0 = time.perf_counter()
                    fut = pool.get(name).submit(wav, sr=rate)

                    def done(f, name=name, t0=t0):
                        with lock:
                            latency[name].append(time.perf_counter() - t0)
                    fut.add_done_callback(done)
                    futures.append((name, i, fut))
            for name, i, fut in futures:
                rows[name][i] = fut.result(timeout=SERVE_TIMEOUT)

        start = time.perf_counter()
        threads = [threading.Thread(target=producer, args=(w,)) for w in range(N_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT)
        elapsed = time.perf_counter() - start
        check(all(r is not None for name in models for r in rows[name]),
              f"serving: every one of the {len(clips)} clips answered by both models")

        # Two requests over HTTP: a .npy body to the float model by name, a
        # WAV body to the pool's default (the int8 model) on the bare route.
        conn = http.client.HTTPConnection(server.host, server.port, timeout=SERVE_TIMEOUT)
        try:
            npy = io.BytesIO()
            np.save(npy, clips[0][0])
            conn.request("POST", "/models/float/embed", body=npy.getvalue())
            http_npy = np.asarray(json.loads(conn.getresponse().read())["output"], np.float32)
            wav_body = io.BytesIO()
            wavfile.write(wav_body, sr, (clips[4][0] * 32767).clip(-32768, 32767).astype(np.int16))
            conn.request("POST", "/embed", body=wav_body.getvalue())
            http_wav = np.asarray(json.loads(conn.getresponse().read())["output"], np.float32)
        finally:
            conn.close()

        def direct(model, wav, rate):
            if rate != sr:
                wav = resample(wav, rate, sr)
            prepared, mask = pad_or_window_np(wav, CLIP_SAMPLES, window_selection="center")
            with torch.no_grad():
                out = model.extract_embeddings(prepared[None], padding_mask=mask[None], aggregation="mean")
            return out[0].float().cpu().numpy()

        def rel(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        for name, model in models.items():
            worst = max(rel(rows[name][i], direct(model, *clips[i])) for i in range(len(clips)))
            check(worst <= SERVE_REL, f"serving {name}: every row vs its clip extracted alone: "
                                      f"worst rel {worst:.3e} <= {SERVE_REL:g}")
        decoded, _ = decode_audio_bytes(wav_body.getvalue())
        r_npy = rel(http_npy, direct(models["float"], clips[0][0], sr))
        r_wav = rel(http_wav, direct(models["int8"], decoded, sr))
        check(r_npy <= SERVE_REL and r_wav <= SERVE_REL,
              f"serving over HTTP: .npy to /models/float rel {r_npy:.3e}, WAV to the default (int8) rel "
              f"{r_wav:.3e} <= {SERVE_REL:g}")
        summary = {}
        for name in models:
            stats = pool.get(name).info()["stats"]
            buckets = stats["bucket_counts"]
            check(all(b & (b - 1) == 0 for b in buckets), f"serving {name}: buckets {sorted(buckets)} powers of two")
            lat = np.asarray(latency[name]) * 1e3
            summary[name] = {"requests_per_s": len(clips) / elapsed, "p50_ms": float(np.percentile(lat, 50)),
                             "p99_ms": float(np.percentile(lat, 99)), "bucket_counts": buckets,
                             "batches": stats["batches"], "padded_rows": stats["padded_rows"],
                             "bucket1_batch_ms": forward_ms[(name, 1)], "bucket32_batch_ms": forward_ms[(name, 32)]}
            print(f"serving {name}: {len(clips)} requests in {elapsed * 1e3:.1f} ms alongside the other model "
                  f"({summary[name]['requests_per_s']:.1f} requests/s), latency p50 {summary[name]['p50_ms']:.1f} ms, "
                  f"p99 {summary[name]['p99_ms']:.1f} ms; buckets {buckets}")
        print(json.dumps({"serving": summary, "producers": N_PRODUCERS, "clips": len(clips),
                          "resample_ms": resample_ms}))
    finally:
        server.stop()
        pool.close()
        del models
        torch.cuda.empty_cache()


def main() -> int:
    start = time.perf_counter()
    phase_card()
    import torch

    phase_build()
    timings = phase_kernels()
    plain_timings, k4_launches = phase_bias_free_kernels()
    k7, k8, k8_launches = phase_int8_kernels()
    launches = phase_main_path()
    launches["int8_dynamic_dense"] = phase_int8_main_path()
    eat_launches = phase_eat()
    aves_launches = phase_aves()
    phase_serving()
    torch.cuda.synchronize()
    print(f"fused_qkv_attention (K5) launched {eat_launches} times on the EAT path and "
          f"{aves_launches} on the AVES path")
    launches["fused_qkv_attention"] = eat_launches + aves_launches
    # No main path reaches K4 (every model's dh-64 projection takes K5, and K4
    # takes dh 64 only) or K8 (in JAX only scripts/bench_int8_matmul.py calls
    # it); drive() checks that each main-path run launched them 0 times.
    # Their kernel-phase launches go under a key of their own.
    launches["plain_attention"] = launches["int8_matmul"] = 0
    kernel_phase = {"plain_attention": k4_launches, "int8_matmul": k8_launches}

    attention = "avex_tpu_torch/ops/csrc/gated_attention.cu"
    int8 = "avex_tpu_torch/ops/csrc/int8_dense.cu"
    # (kernel, source, line of the TPU kernel, timing at the main path's shape and compute dtype, bf16)
    rows = (
        ("gated_bias_attention", attention, "avex_tpu/ops/pallas_attention.py:126",
         timings[("gated_bias_attention", "bfloat16")]),
        ("fused_qkv_gated_attention", attention, "avex_tpu/ops/pallas_attention.py:389",
         timings[("fused_qkv_gated_attention", "bfloat16")]),
        ("plain_attention", attention, "avex_tpu/ops/pallas_attention.py:161",
         plain_timings[("plain_attention", "EAT", "bfloat16")]),
        ("fused_qkv_attention", attention, "avex_tpu/ops/pallas_attention.py:344",
         plain_timings[("fused_qkv_attention", "EAT", "bfloat16")]),
        ("int8_dynamic_dense", int8, "avex_tpu/ops/pallas_int8.py:100", k7),
        ("int8_matmul", int8, "avex_tpu/ops/pallas_int8.py:46", k8),
    )
    kernels = []
    for kname, source, replaces, t in rows:
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if kname in kernel_phase:
            kernels[-1]["kernel_phase_launches"] = kernel_phase[kname]
            check(kernel_phase[kname] > 0, f"{kname} ran in the kernel phase (no main path reaches it)")
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
