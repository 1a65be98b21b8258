#!/usr/bin/env python3
"""Stage counts of K7's wgmma product, timed on one GPU.

    python3 scripts/torch_int8_shapes.py

``avex_tpu_torch/ops/csrc/int8_dense.cu``'s scaled product runs a ring of
``kStages`` TMA-fed stages of 32 KB and asks for two blocks an SM. This
script compiles the same source with other stage counts and blocks an SM,
holds each build's product to ``scaled_product_reference`` (bit for bit) and
times it (median of 30 launches, CUDA events, each launch queued behind a
sleep kernel) at BEATs' three int8 shapes for a B=128 batch (M = 31,744),
bf16 output with the bias; the builds take turns, twice each. Needs CUDA and
``nvcc``; imports nothing of JAX. The builds go to ``build/int8_shapes/``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (stages, blocks an SM asked of the compiler), the launched one first. Two
# stages leave too little room to stage an fp32 output tile, and three blocks
# an SM too few registers for the 64 accumulators (ptxas refuses).
VARIANTS = [(3, 2), (4, 1), (3, 1), (6, 1)]
SHAPES = {"fc1": (768, 3072), "fc2": (3072, 768), "q/k/v/out_proj": (768, 768)}
M = 31_744


def build(stages: int, blocks: int):
    from avex_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "int8_dense.cu").read_text()
    for old, new in (("constexpr int kStages = 3;", f"constexpr int kStages = {stages};"),
                     ("__launch_bounds__(kPThreads, 2)", f"__launch_bounds__(kPThreads, {blocks})")):
        if old not in text:
            raise SystemExit(f"int8_dense.cu no longer holds {old!r}")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "int8_shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = out_dir / f"int8_dense_{stages}_{blocks}.cu"
    source.write_text(text)
    library = source.with_suffix(".so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(library), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(f"  <{stages} stages, {blocks} blocks an SM>: {' | '.join(regs[:2])}")
    lib = ctypes.CDLL(str(library))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.avex_int8_scaled_product.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
    return lib


def median_ms(fn, n: int = 30) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> int:
    import torch

    from avex_tpu_torch.ops import int8_kernels as ik

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {v: build(*v) for v in VARIANTS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (k, n) in SHAPES.items():
        x = torch.randn(M, k, device="cuda", generator=gen).bfloat16()
        wq = torch.randint(-127, 128, (n, k), device="cuda", dtype=torch.int8, generator=gen)
        scale = torch.rand(n, device="cuda", generator=gen) * 0.01 + 1e-3
        bias = torch.randn(n, device="cuda", generator=gen)
        xq, row_scale = ik._quantize_rows_kernel(x)
        want = ik.scaled_product_reference(xq, row_scale, wq, scale, bias, torch.bfloat16)
        out = torch.empty(M, n, dtype=torch.bfloat16, device="cuda")
        times = {v: [] for v in VARIANTS}
        for turn in (VARIANTS, VARIANTS[::-1]):
            for v in turn:
                def call(lib=libs[v]):
                    return lib.avex_int8_scaled_product(1, xq.data_ptr(), row_scale.data_ptr(), wq.data_ptr(),
                                                        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), M, n, k,
                                                        stream)
                err = call()
                torch.cuda.synchronize()
                if err != 0 or not torch.equal(out, want):
                    print(f"{name} <{v[0]} stages, {v[1]} blocks an SM>: launch {err}, not the twin's")
                    return 1
                times[v].append(median_ms(call))
        for v, t in times.items():
            print(f"{name} M={M} K={k} N={n} <{v[0]} stages, {v[1]} blocks an SM>: exact, "
                  f"{' / '.join(f'{ms:.4f}' for ms in t)} ms, {2 * M * k * n / min(t) / 1e9:.1f} TOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
