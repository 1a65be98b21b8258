#!/usr/bin/env python3
"""The fp32 attention forward (K1, K2, K4, K5) and backward (K3, K6) on the
card: the 3xTF32 tensor-core kernels against the plain fp32 twin and SDPA.

    python3 scripts/torch_tf32x3_backward.py

Builds ``csrc/tf32x3_attention.cu`` at every head width of
``attention_kernels.KERNEL_WIDTHS``, one ``nvcc`` each, all at once, and
prints each 3xTF32 kernel's registers and spills. Then, for each forward
case, the fp32 forward of
``gated_bias_attention`` (K1 with a bias, K4 without) or
``fused_qkv_gated_attention`` / ``fused_qkv_attention`` (K2, K5) against
the plain fp32 twin with TF32 off (max|d| 1e-4 and rel L2 1e-5, NaN
exactly where the twin has NaN; K2 and K5 also their saved row
log-sum-exp within 1e-5 of the twin's), the body that ran it
(``attention_kernels.FORWARD_BODIES``) and, for the timed cases, the median
device time of 20 calls of the 3xTF32 kernel, the twin and SDPA's fp32 call
(and SDPA's backend), beside the bound at 165 TFLOP/s, and the kernel's
device time per call from ``torch.profiler``. Then, for each backward case, the fp32
backward of ``fused_qkv_gated_attention`` (K3) or
``fused_qkv_attention`` (K6) through autograd against the plain fp32 twin
with TF32 off (rel L2 of dqkv, dbias and dgate; NaN exactly where the twin
has NaN), the body that ran it (``attention_kernels.BACKWARD_BODIES``) and,
for the timed cases, the median device time of 20 calls (each behind a sleep
kernel) of the 3xTF32 kernels, the twin and SDPA's fp32 backward, beside
the bound at 165 TFLOP/s (3xTF32: three TF32 products a product), and each
3xTF32 kernel's device time per call from ``torch.profiler``. Exits 1 on a failed
check. Needs CUDA and ``nvcc``; imports nothing of JAX.

    python3 scripts/torch_tf32x3_backward.py general [--root CHECKOUT]
    python3 scripts/torch_tf32x3_backward.py general-ab PARENT

``general`` times the fp32 forward and backward of the general route
(narrow rows and column chunks past 128: dh 12, 20, 136, 192, 256, 320) at
the shapes ``chip_smoke.py``'s phase 35 times them (K1/K2 at B=128, T=248
with the gate, K4/K5 at B=128, T=513, K3 at B=64, T=248 with the gate, K6
at B=64, T=513; E = 768 or the nearest multiple of dh), and dh 64 on
16-byte rows (the main paths' widths) as the control, on whichever body the
checkout runs them (``--root``: another checkout's ``avex_tpu_torch``,
built in its own ``build/``), each against the plain fp32 twin (K2's and
K5's saved row log-sum-exp too), beside SDPA's fp32 call (or backward) and
the 3xTF32 bound; one JSON line a case. ``general-ab PARENT`` runs
``general`` on PARENT, this checkout, this checkout and PARENT, one process
each, on the same seeded inputs, and prints each case's medians side by
side.

    python3 scripts/torch_tf32x3_backward.py narrow-tile

``narrow-tile`` times the narrow-row forwards at dh 12 (K1, K2, K4, K5 at
``general``'s shapes) on the 16-column tiles the 32 build runs them on
against the build's own 32-column tiles (``csrc/tf32x3_attention.cu``
compiled once more without the 16-column launch: ``build/narrow32/``), each
held to the twin, in turns (32, 16, 16, 32).
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# ``general --root CHECKOUT`` imports that checkout's package instead of this one's
sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1] if "--root" in sys.argv[:-1] else str(ROOT))

REL_L2 = 1e-5  # the forward's output, and each of dqkv, dbias and dgate, against the plain fp32 twin
ATOL = 1e-4  # the forward's output against the twin: max|d|
LSE_ATOL = 1e-5  # the saved row log-sum-exp against the twin's
TF32X3_FLOPS = 495e12 / 3
E = 768
# (kernel, label, batch, heads, T, gated, masked, timed): K1/K4 on split views, K2/K5 on [B, T, 3E]
FORWARD_CASES = (
    ("K5", "EAT", 128, 12, 513, None, None, True),
    ("K5", "EAT", 128, 12, 513, None, "some keys", False),
    ("K5", "AVES", 128, 12, 249, None, "frames", False),
    ("K4", "EAT", 128, 12, 513, None, None, True),
    ("K2", "BEATs", 128, 12, 248, "gate", None, True),
    ("K2", "BEATs", 128, 12, 248, "bias only", "an item all padded", False),
    ("K1", "BEATs", 128, 12, 248, "gate", None, True),
    ("K5", "Bird-MAE huge", 128, 16, 513, None, None, True),
    ("K5", "dh16", 128, 48, 513, None, None, True),
    ("K5", "dh32", 128, 24, 513, None, None, True),
    ("K5", "dh96", 128, 8, 513, None, None, True),
    ("K5", "dh128", 128, 6, 513, None, None, True),
    ("K2", "dh32", 128, 24, 248, "gate", None, True),
    ("K2", "dh128", 128, 6, 248, "gate", None, True),
    ("K2", "ragged", 8, 12, 37, "gate", "an item all padded", False),
    ("K5", "ragged dh40", 8, 4, 37, None, "an item all padded", False),
)
CASES = (
    ("K3", "BEATs", 64, 12, 248, "gate", None, True),
    ("K3", "BEATs", 64, 12, 248, "gate", "some keys", False),
    ("K3", "BEATs", 64, 12, 248, "bias only", "some keys", False),
    ("K3", "long", 4, 12, 800, "gate", None, True),
    ("K3", "long", 4, 12, 520, "gate", "some keys", False),
    ("K6", "EAT", 64, 12, 513, None, None, True),
    ("K6", "EAT", 64, 12, 513, None, "some keys", False),
    ("K6", "AVES", 64, 12, 249, None, "frames", False),
    ("K6", "Bird-MAE huge", 64, 16, 513, None, None, True),
    ("K6", "dh16", 64, 48, 513, None, None, True),
    ("K6", "dh32", 64, 24, 513, None, None, True),
    ("K6", "dh96", 64, 8, 513, None, None, True),
    ("K6", "dh128", 64, 6, 513, None, None, True),
    ("K3", "dh32", 64, 24, 248, "gate", None, True),
    ("K3", "dh128", 64, 6, 248, "gate", None, True),
    ("K3", "ragged", 8, 12, 37, "gate", "an item all padded", False),
    ("K6", "ragged dh40", 8, 4, 37, None, "an item all padded", False),
)


# The general route's widths, timed as chip_smoke.py's phase 35 times them (WH_TIMED),
# and dh 64 (12 heads: K3 BEATs, K6 EAT) on 16-byte rows beside them as the control
GENERAL_WIDTHS = (12, 20, 136, 192, 256, 320, 64)
GENERAL_REPS = 10


def general_forward_cases(gen) -> int:
    """The general route's K1, K2, K4 and K5 (``general``); returns the
    failed checks. Each case: the body that ran it, max|d| and relative L2
    against the twin, K2's and K5's saved row log-sum-exp against the
    twin's, the median ms of GENERAL_REPS calls and each kernel's device ms
    from the profiler, SDPA's fp32 call and backend on the same views, and
    the 3xTF32 bound."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak
    from chip_smoke import median_ms, rel_l2, sdpa_backend

    failures = 0
    for dh in GENERAL_WIDTHS:
        heads = max(1, round(E / dh))
        for kname, seq in (("K1", 248), ("K2", 248), ("K4", 513), ("K5", 513)):
            bsz, gated = 128, kname in ("K1", "K2")
            qkv = torch.randn(bsz, seq, 3 * heads * dh, device="cuda", generator=gen)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
            bias = torch.randn(heads, seq, seq, device="cuda", generator=gen) if gated else None
            gate = torch.rand(bsz, heads, seq, device="cuda", generator=gen) + 1.0 if gated else None

            def run():
                if kname in ("K1", "K4"):
                    return ak.gated_bias_attention(q, k, v, bias, gate)
                out = (ak.fused_qkv_gated_attention(qkv, heads, bias, gate) if gated
                       else ak.fused_qkv_attention(qkv, heads))
                return out.view(bsz, seq, heads, dh).permute(0, 2, 1, 3)

            ak.reset_launch_counts()
            with torch.no_grad():
                got = run()
                want = ak.gated_bias_attention_reference(q, k, v, bias, gate)
            torch.cuda.synchronize()
            row = {"case": f"{kname} dh={dh} H={heads} B={bsz} T={seq}",
                   "bodies": {"forward": {k_: v_ for k_, v_ in ak.FORWARD_BODIES.items() if v_}},
                   "max_abs_err": float((got - want).abs().max()), "rel_l2": rel_l2(got, want)}
            ok = row["max_abs_err"] <= ATOL and row["rel_l2"] <= REL_L2
            del got, want
            if kname in ("K2", "K5"):
                leaf = qkv.detach().requires_grad_()
                out = (ak.fused_qkv_gated_attention(leaf, heads, bias, gate) if gated
                       else ak.fused_qkv_attention(leaf, heads))
                lse = out.grad_fn.saved_tensors[-1]
                with torch.no_grad():
                    _, want_lse, _ = ak._fused_qkv_forward_lse_reference(qkv, heads, None, None, bias, gate)
                row["lse_max_abs_err"] = float((lse - want_lse).abs().max())
                ok &= row["lse_max_abs_err"] <= LSE_ATOL
                del leaf, out, lse, want_lse
            with torch.no_grad():
                row["ms"] = median_ms(run, GENERAL_REPS)
                row["kernels_ms"] = kernel_ms(run, 3)
                attn = None if bias is None else gate[..., None] * bias[None]
                row["sdpa_ms"] = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn,
                                                                                  scale=dh**-0.5), GENERAL_REPS)
                row["sdpa_backend"] = sdpa_backend(q, k, v, attn)
            row["bound_tf32x3_ms"] = 4.0 * bsz * heads * seq * seq * dh / TF32X3_FLOPS * 1e3
            row["ok"] = ok
            print(("ok    " if ok else "FAIL  ") + json.dumps(row), flush=True)
            failures += not ok
            del qkv, q, k, v, bias, gate, attn
            torch.cuda.empty_cache()
    return failures


def general_cases() -> int:
    """The general route's K3 and K6 (``general``); returns the failed
    checks. Each case: the forward and backward bodies that ran, dqkv's
    relative L2 and max|d| against the twin (and dbias's and dgate's relative
    L2), the median ms of GENERAL_REPS backward calls and each kernel's
    device ms from the profiler, SDPA's fp32 backward and backend on the
    same views, and the 3xTF32 bound."""
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak
    from chip_smoke import median_ms, rel_l2, sdpa_backend, sdpa_backward_ms

    gen = torch.Generator(device="cuda").manual_seed(21)
    failures = 0
    for dh in GENERAL_WIDTHS:
        heads = max(1, round(E / dh))
        for kname, seq in (("K3", 248), ("K6", 513)):
            bsz, width = 64, heads * dh
            qkv = torch.randn(bsz, seq, 3 * width, device="cuda", generator=gen).requires_grad_()
            dout = torch.randn(bsz, seq, width, device="cuda", generator=gen)
            leaves, bias, gate = [qkv], None, None
            if kname == "K3":
                bias = torch.randn(heads, seq, seq, device="cuda", generator=gen).requires_grad_()
                gate = (torch.rand(bsz, heads, seq, device="cuda", generator=gen) + 1.0).requires_grad_()
                leaves += [bias, gate]
            ak.reset_launch_counts()
            out = (ak.fused_qkv_attention(qkv, heads) if bias is None
                   else ak.fused_qkv_gated_attention(qkv, heads, bias, gate))
            got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
            torch.cuda.synchronize()
            bodies = {"forward": {k: v for k, v in ak.FORWARD_BODIES.items() if v},
                      "backward": {k: v for k, v in ak.BACKWARD_BODIES.items() if v}}
            with torch.no_grad():
                if bias is None:
                    want = (ak.fused_qkv_backward_reference(qkv.detach(), heads, None, dout),)
                else:
                    want = ak.fused_qkv_gated_backward_reference(qkv.detach(), heads, bias.detach(), gate.detach(),
                                                                 None, dout)
            row = {"case": f"{kname} dh={dh} H={heads} B={bsz} T={seq}", "bodies": bodies,
                   "max_abs_err": float((got[0] - want[0]).abs().max()),
                   "rel_l2": {n: rel_l2(g, w) for n, g, w in zip(("dqkv", "dbias", "dgate"), got, want)}}
            ok = row["max_abs_err"] <= ATOL and all(math.isfinite(r) for r in row["rel_l2"].values())
            if bodies["backward"] == {"tf32x3": 1}:  # the 3xTF32 kernels: the card's relative L2 as well
                ok &= row["rel_l2"]["dqkv"] <= REL_L2
            del want
            row["ms"] = median_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), GENERAL_REPS)
            row["kernels_ms"] = kernel_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), 3)
            q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                       for t in qkv.detach().view(bsz, seq, 3, heads, dh).unbind(2))
            attn = None if bias is None else (gate.detach()[..., None] * bias.detach()[None]).requires_grad_()
            row["sdpa_ms"] = sdpa_backward_ms(q, k, v, attn, dout, GENERAL_REPS)
            row["sdpa_backend"] = sdpa_backend(q, k, v, attn)
            row["bound_tf32x3_ms"] = 10.0 * bsz * heads * seq * seq * dh / TF32X3_FLOPS * 1e3
            row["ok"] = ok
            print(("ok    " if ok else "FAIL  ") + json.dumps(row), flush=True)
            failures += not ok
            del qkv, dout, leaves, bias, gate, out, got, q, k, v, attn
            torch.cuda.empty_cache()
    return failures


def general_ab(parent: str) -> int:
    """``general`` on PARENT, this checkout, this checkout and PARENT, one
    process each; prints each case's times side by side (the median of
    each checkout's two runs). Returns the failed runs."""
    import statistics

    runs, failures = [], 0
    for root in (parent, str(ROOT), str(ROOT), parent):
        here = root == str(ROOT)  # this checkout's runs build here and print the builds' registers
        proc = subprocess.run([sys.executable, __file__, "general", *([] if here else ["--root", root])],
                              capture_output=True, text=True)
        print(f"--- general on {root}: exit {proc.returncode}\n{proc.stdout}{proc.stderr[-3000:]}", flush=True)
        failures += proc.returncode != 0
        runs.append({row["case"]: row for row in (json.loads(line[6:]) for line in proc.stdout.splitlines()
                                                  if line[:6] in ("ok    ", "FAIL  "))})
    for case in runs[1]:
        before = [r[case]["ms"] for r in (runs[0], runs[3]) if case in r]
        after = [runs[i][case]["ms"] for i in (1, 2)]
        row = runs[1][case]
        print("ab " + json.dumps({"case": case, "parent_ms": before, "change_ms": after,
                                  "parent_over_change": statistics.median(before) / statistics.median(after)
                                  if before else None,
                                  "sdpa_ms": row["sdpa_ms"], "sdpa_backend": row["sdpa_backend"],
                                  "bound_tf32x3_ms": row["bound_tf32x3_ms"],
                                  "parent_bodies": runs[0].get(case, {}).get("bodies"), "bodies": row["bodies"]}))
    return failures


def narrow_tile() -> int:
    """``narrow-tile``; returns the failed checks."""
    import ctypes
    import statistics

    import torch

    from avex_tpu_torch.ops import _build
    from avex_tpu_torch.ops import attention_kernels as ak
    from chip_smoke import median_ms, rel_l2

    out_dir = _build.BUILD_DIR / "narrow32"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / ak.TF32X3_SOURCE).read_text()
    launch16 = "if (cl.narrow && cl.dim <= 16) return launch(tf32x3_forward_kernel<16, kGated, true>"
    assert text.count(launch16) == 1
    (out_dir / ak.TF32X3_SOURCE).write_text(text.replace(launch16, launch16.replace(
        "cl.narrow && cl.dim <= 16", "false")))
    lib_path = out_dir / "tf32x3_attention-d32.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DAVEX_HEAD_DIM=32", "-o", str(lib_path),
                           str(out_dir / ak.TF32X3_SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr)
        return 1
    lib32 = ctypes.CDLL(str(lib_path))
    load = ak.load_library
    gen = torch.Generator(device="cuda").manual_seed(23)
    dh, heads, failures, times = 12, 64, 0, {}
    for kname, seq in (("K1", 248), ("K2", 248), ("K4", 513), ("K5", 513)):
        bsz, gated = 128, kname in ("K1", "K2")
        qkv = torch.randn(bsz, seq, 3 * heads * dh, device="cuda", generator=gen)
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
        bias = torch.randn(heads, seq, seq, device="cuda", generator=gen) if gated else None
        gate = torch.rand(bsz, heads, seq, device="cuda", generator=gen) + 1.0 if gated else None

        def run():
            if kname in ("K1", "K4"):
                return ak.gated_bias_attention(q, k, v, bias, gate)
            out = (ak.fused_qkv_gated_attention(qkv, heads, bias, gate) if gated
                   else ak.fused_qkv_attention(qkv, heads))
            return out.view(bsz, seq, heads, dh).permute(0, 2, 1, 3)

        with torch.no_grad():
            want = ak.gated_bias_attention_reference(q, k, v, bias, gate)
            for build in (32, 16, 16, 32):
                ak.load_library = (lambda source, width: lib32) if build == 32 else load
                got = run()
                err, rel = float((got - want).abs().max()), rel_l2(got, want)
                ok = err <= ATOL and rel <= REL_L2
                failures += not ok
                times.setdefault((kname, build), []).append(median_ms(run, GENERAL_REPS))
                print(("ok    " if ok else "FAIL  ") + json.dumps(
                    {"case": f"{kname} dh={dh} H={heads} B={bsz} T={seq} on {build}-column tiles",
                     "max_abs_err": err, "rel_l2": rel, "ms": times[kname, build][-1]}), flush=True)
            ak.load_library = load
        del qkv, q, k, v, bias, gate, want
        torch.cuda.empty_cache()
    for (kname, build), ms in times.items():
        print(f"narrow-tile {kname} dh={dh} {build}-column tiles: median of two runs {statistics.median(ms):.4f} ms "
              f"{ms}")
    return failures


def build() -> int:
    """Every build the cases need, at once; prints the 3xTF32 kernels'
    ptxas lines. Returns the kernels that spill."""
    from avex_tpu_torch.ops import _build
    from avex_tpu_torch.ops import attention_kernels as ak

    jobs = [(ak.TF32X3_SOURCE, w) for w in ak.KERNEL_WIDTHS]
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build(*job), jobs))
    print(f"build: {len(jobs)} builds in {time.perf_counter() - start:.1f} s")
    spills = 0
    for name, (seconds, log) in sorted(_build.BUILD_LOG.items()):
        print(f"  {name}: nvcc {seconds:.1f} s")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and name.startswith(ak.TF32X3_SOURCE):
                print(f"    {kernel}: {line.split(':', 1)[-1].strip()}")
                if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                    spills += 1
    return spills


def kernel_ms(fn, n: int = 5) -> dict:
    """Device ms per call of each 3xTF32 kernel ``fn`` launches, from the
    profiler over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        name = re.search(r"(tf32x3_\w+_kernel|sum_chunks_kernel|attention_\w*kernel)(<[^>]*>)?", evt.key)
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if name and total:
            times[name.group(0)] = times.get(name.group(0), 0.0) + total / n / 1e3
    return times


def case_dim(label: str, heads: int, kname: str) -> int:
    """The head width of a case: E = 768 over its heads, 80 for Bird-MAE
    huge, and the ragged cases' own."""
    if label == "Bird-MAE huge":
        return 80
    if label.startswith("ragged"):
        return 64 if kname in ("K1", "K2", "K3") else 40
    return E // heads


def forward_cases(gen) -> int:
    """The forward cases; returns the failed ones."""
    import torch
    import torch.nn.functional as F

    from avex_tpu_torch.ops import attention_kernels as ak
    from chip_smoke import median_ms, rel_l2, sdpa_backend

    failures = 0
    for kname, label, bsz, heads, seq, gating, masking, timed in FORWARD_CASES:
        dim = case_dim(label, heads, kname)
        qkv = torch.randn(bsz, seq, 3 * heads * dim, device="cuda", generator=gen)
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dim).unbind(2))
        mask = None
        if masking is not None:
            mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
            mask[1::3, seq * 2 // 3:] = True
            if masking == "an item all padded":
                mask[0] = True
        bias = gate = None
        if gating is not None:
            bias = torch.randn(heads, seq, seq, device="cuda", generator=gen)
            if gating == "gate":
                gate = torch.rand(bsz, heads, seq, device="cuda", generator=gen) + 1.0
        if kname in ("K1", "K4"):
            def run():
                return ak.gated_bias_attention(q, k, v, bias, gate, mask)
        elif bias is None:
            def run():
                return ak.fused_qkv_attention(qkv, heads, mask)
        else:
            def run():
                return ak.fused_qkv_gated_attention(qkv, heads, bias, gate, mask)

        def twin():
            return ak.gated_bias_attention_reference(q, k, v, bias, gate, mask)

        ak.reset_launch_counts()
        with torch.no_grad():
            got = run()
            if kname in ("K2", "K5"):
                got = got.view(bsz, seq, heads, dim).permute(0, 2, 1, 3)
            want = twin()
        torch.cuda.synchronize()
        bodies = dict(ak.FORWARD_BODIES)
        tag = f"{kname} {label} B={bsz} H={heads} dh={dim} T={seq} gate={gating} mask={masking}"
        nan = torch.isnan(want)
        ok = bodies == {"bf16": 0, "tf32x3": 1} and bool(torch.equal(torch.isnan(got), nan))
        err = float((got[~nan] - want[~nan]).abs().max())
        row = {"case": tag, "bodies": bodies, "max_abs_err": err, "rel_l2": rel_l2(got[~nan], want[~nan])}
        ok &= err <= ATOL and row["rel_l2"] <= REL_L2
        del got, want
        if kname in ("K2", "K5"):
            leaf = qkv.detach().requires_grad_()
            out = (ak.fused_qkv_attention(leaf, heads, mask) if bias is None
                   else ak.fused_qkv_gated_attention(leaf, heads, bias, gate, mask))
            lse = out.grad_fn.saved_tensors[-1]
            with torch.no_grad():
                _, want_lse, _ = ak._fused_qkv_forward_lse_reference(qkv, heads, mask, None, bias, gate)
            finite = torch.isfinite(want_lse)
            row["lse_max_abs_err"] = float((lse[finite] - want_lse[finite]).abs().max())
            ok &= bool(torch.equal(torch.isfinite(lse), finite)) and row["lse_max_abs_err"] <= LSE_ATOL
            del leaf, out, lse, want_lse
        row["ok"] = ok
        if timed:
            flops = 4.0 * bsz * heads * seq * seq * dim
            attn = None if bias is None else (gate[..., None] * bias[None] if gate is not None else bias[None])
            with torch.no_grad():
                row["ms"] = median_ms(run)
                row["kernels_ms"] = kernel_ms(run)
                row["plain_ms"] = median_ms(twin)
                row["sdpa_ms"] = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn,
                                                                                  scale=dim**-0.5))
            row["sdpa_backend"] = sdpa_backend(q, k, v, attn)
            row["bound_tf32x3_ms"] = flops / TF32X3_FLOPS * 1e3
            row["sdpa_over_kernel"] = row["sdpa_ms"] / row["ms"]
            del attn
        print(("ok    " if ok else "FAIL  ") + json.dumps(row))
        failures += not ok
        del qkv, q, k, v, mask, bias, gate
        torch.cuda.empty_cache()
    return failures


def main() -> int:
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak
    from chip_smoke import median_ms, rel_l2, sdpa_backward_ms

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["general-ab"]:
        return 1 if general_ab(sys.argv[2]) else 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if sys.argv[1:2] == ["narrow-tile"]:
        failures = narrow_tile()
        print(f"{failures} failure(s) on {smi}")
        return 1 if failures else 0
    if sys.argv[1:2] == ["general"]:
        failures = build() if "--root" not in sys.argv else 0
        failures += general_forward_cases(torch.Generator(device="cuda").manual_seed(22))
        failures += general_cases()
        print(f"{failures} failure(s) on {smi}")
        return 1 if failures else 0
    failures = build()
    print(f"spilling 3xTF32 kernels: {failures}")
    gen = torch.Generator(device="cuda").manual_seed(19)
    failures += forward_cases(gen)
    report = []
    for kname, label, bsz, heads, seq, gating, masking, timed in CASES:
        dim = case_dim(label, heads, kname)
        width = heads * dim
        qkv = torch.randn(bsz, seq, 3 * width, device="cuda", generator=gen).requires_grad_()
        dout = torch.randn(bsz, seq, width, device="cuda", generator=gen)
        mask = None
        if masking is not None:
            mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
            mask[1::3, seq * 2 // 3:] = True
            if masking == "an item all padded":
                mask[0] = True
        bias = gate = None
        leaves = [qkv]
        if gating is not None:
            bias = torch.randn(heads, seq, seq, device="cuda", generator=gen).requires_grad_()
            leaves.append(bias)
            if gating == "gate":
                gate = (torch.rand(bsz, heads, seq, device="cuda", generator=gen) + 1.0).requires_grad_()
                leaves.append(gate)

        def forward():
            if bias is None:
                return ak.fused_qkv_attention(qkv, heads, mask)
            return ak.fused_qkv_gated_attention(qkv, heads, bias, gate, mask)

        ak.reset_launch_counts()
        out = forward()
        got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
        bodies = dict(ak.BACKWARD_BODIES)
        detached = (qkv.detach(), bias.detach() if bias is not None else None,
                    gate.detach() if gate is not None else None)
        if bias is None:
            want = (ak.fused_qkv_backward_reference(detached[0], heads, mask, dout),)
        else:
            want = ak.fused_qkv_gated_backward_reference(detached[0], heads, detached[1], detached[2], mask, dout)
        torch.cuda.synchronize()
        tag = f"{kname} {label} B={bsz} H={heads} dh={dim} T={seq} gate={gating} mask={masking}"
        ok = bodies == {"bf16": 0, "tf32x3": 1}
        rels = {}
        for name, g, w in zip(("dqkv", "dbias", "dgate"), got, want):
            if w is None:
                continue
            nan = torch.isnan(w)
            ok &= bool(torch.equal(torch.isnan(g), nan)) and bool(torch.isfinite(g[~nan]).all())
            if not nan.all():
                rels[name] = rel_l2(g[~nan], w[~nan])
                ok &= rels[name] <= REL_L2
        row = {"case": tag, "bodies": bodies, "rel_l2": rels, "ok": ok}
        if timed:
            flops = 10.0 * bsz * heads * seq * seq * dim
            row["ms"] = median_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
            row["kernels_ms"] = kernel_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
            if bias is None:
                row["plain_ms"] = median_ms(lambda: ak.fused_qkv_backward_reference(detached[0], heads, mask, dout))
            else:
                row["plain_ms"] = median_ms(lambda: ak.fused_qkv_gated_backward_reference(
                    detached[0], heads, detached[1], detached[2], mask, dout))
            q, k, v = (t.detach().permute(0, 2, 1, 3).requires_grad_()
                       for t in detached[0].view(bsz, seq, 3, heads, dim).unbind(2))
            attn = None
            if bias is not None:
                attn = (detached[2][..., None] * detached[1][None]).requires_grad_()
            row["sdpa_ms"] = sdpa_backward_ms(q, k, v, attn, dout)
            row["bound_tf32x3_ms"] = flops / TF32X3_FLOPS * 1e3
            del q, k, v, attn
        print(("ok    " if ok else "FAIL  ") + json.dumps(row))
        failures += not ok
        report.append(row)
        del qkv, dout, mask, bias, gate, leaves, out, got, want, detached
        torch.cuda.empty_cache()
    print(f"{failures} failure(s) on {smi}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
