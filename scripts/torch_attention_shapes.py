#!/usr/bin/env python3
"""Block shapes of the bf16 tensor-core attention kernels, timed on one GPU.

    python3 scripts/torch_attention_shapes.py [gated] [forward] [backward] [dbias]

The kernels of ``avex_tpu_torch/ops/csrc/tensor_core_attention.cu`` are
templates over the block's shape: warps per block, groups of 16 rows per
warp and (forward) keys per streamed tile. The entry points launch one
shape each. This script compiles the same source with extra entry points
that launch any of the shapes below, holds each against the plain twin and
times it (median of 30 launches, CUDA events, around the launch alone): the gated forward (K1/K2) at BEATs' shape (B=128, T=248, with the
gate), the bias-free forward at EAT's (B=128, T=513) and AVES's (B=128,
T=249, a third of the clips padded), the backward at their training
shapes (B=64), and the gated backward's dbias kernel at BEATs' training
shape (B=64, T=248, with the gate; held to the dbias of the whole K3). With
no argument it runs all four groups. Needs CUDA and ``nvcc``; imports
nothing of JAX. The build goes to ``build/shapes/``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (warps, groups of 16 rows a warp, keys a tile) of the forward;
# (warps, groups) of the dQ kernel and of the dK/dV kernel.
FORWARD_SHAPES = ["4, 1, 64", "4, 1, 128", "8, 1, 64", "8, 1, 128", "4, 2, 64"]
# The gated forward: (warps, groups, keys, gated), the launched one first.
GATED_SHAPES = [f"{shape}, true" for shape in ("4, 1, 64", "8, 1, 64", "4, 2, 64", "4, 1, 128")]
BACKWARD_SHAPES = [("4, 1", "4, 1"), ("8, 1", "4, 1"), ("4, 1", "8, 1")]
# The dbias kernel: (warps, groups), 16·warps·groups queries a block, and batch items a
# chunk (the chunks' partials summed after), the launched shape first.
DBIAS_SHAPES = [("4, 1", items) for items in (64, 32, 22, 16, 11, 8)] + [("2, 1", 22), ("8, 1", 22)]
H, D = 12, 64
E = H * D


def build():
    from avex_tpu_torch.ops import _build

    entry = [
        'extern "C" int shape_forward(int shape, const void* q, const void* k, const void* v, const void* pad,'
        ' void* out, int batch, int heads, int seq, float scale, const long long* strides, void* stream) {',
        "  FwdStrides s; memcpy(&s, strides, sizeof(FwdStrides)); cudaStream_t st = (cudaStream_t)stream;",
        *[f"  if (shape == {n}) return (int)launch_forward<64, {a}>(q, k, v, pad, out, nullptr, nullptr, batch,"
          f" heads, seq, scale, s, st);" for n, a in enumerate(FORWARD_SHAPES)],
        "  return -1; }",
        'extern "C" int shape_gated_forward(int shape, const void* q, const void* k, const void* v, const void* bias,'
        ' const void* gate, const void* pad, void* out, int batch, int heads, int seq, float scale,'
        ' const long long* strides, void* stream) {',
        "  FwdStrides s; const Gated gd = gated_operands(bias, gate, seq, strides, &s);"
        " cudaStream_t st = (cudaStream_t)stream;",
        *[f"  if (shape == {n}) return (int)launch_forward<64, {a}>(q, k, v, pad, out, nullptr, nullptr, batch,"
          f" heads, seq, scale, s, st, gd);" for n, a in enumerate(GATED_SHAPES)],
        "  return -1; }",
        'extern "C" int shape_backward(int shape, const void* q, const void* k, const void* v, const void* out,'
        " const void* out_rest, const void* dout, const void* pad, const void* lse, void* dq, void* dk, void* dv,"
        " void* delta, int batch, int heads, int seq, float scale, const long long* strides, void* stream) {",
        "  BwdStrides s; memcpy(&s, strides, sizeof(BwdStrides)); cudaStream_t st = (cudaStream_t)stream;",
        *[f"  if (shape == {n}) {{ cudaError_t err = launch_dq<64, {a}>(q, k, v, out, out_rest, dout, pad, lse, dq,"
          f" delta, batch, heads, seq, scale, s, st); if (err != cudaSuccess) return (int)err; return (int)"
          f"launch_dkv<64, {b}>(q, k, v, dout, pad, lse, delta, dk, dv, batch, heads, seq, scale, s, st); }}"
          for n, (a, b) in enumerate(BACKWARD_SHAPES)],
        "  return -1; }",
        'extern "C" int shape_dbias(int shape, const void* q, const void* k, const void* v, const void* dout,'
        " const void* bias, const void* gate, const void* lse, const void* delta, void* dbias, void* part, int batch,"
        " int items, int heads, int seq, float scale, const long long* strides, void* stream) {",
        "  BwdStrides s; memcpy(&s, strides, sizeof(BwdStrides)); cudaStream_t st = (cudaStream_t)stream;"
        " const Gated gd = make_gated(bias, gate, seq, strides + 26, strides + 29);",
        *[f"  if (shape == {n}) return (int)launch_dbias<64, {a}>(q, k, v, dout, nullptr, lse, delta, dbias, part, batch,"
          f" items, heads, seq, scale, s, st, gd);" for n, (a, _) in enumerate(DBIAS_SHAPES)],
        "  return -1; }",
    ]
    out_dir = _build.BUILD_DIR / "shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = out_dir / "tensor_core_attention_shapes.cu"
    source.write_text((_build.CSRC_DIR / "tensor_core_attention.cu").read_text() + "\n" + "\n".join(entry) + "\n")
    library = out_dir / "tensor_core_attention_shapes.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(library), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    lib = ctypes.CDLL(str(library))
    p, i, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.shape_forward.argtypes = [i] + [p] * 5 + [i, i, i, ctypes.c_float, strides, p]
    lib.shape_gated_forward.argtypes = [i] + [p] * 7 + [i, i, i, ctypes.c_float, strides, p]
    lib.shape_backward.argtypes = [i] + [p] * 12 + [i, i, i, ctypes.c_float, strides, p]
    lib.shape_dbias.argtypes = [i] + [p] * 10 + [i, i, i, i, ctypes.c_float, strides, p]
    return lib


def median_ms(fn, n: int = 30) -> float:
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


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def padding(bsz, seq, masked):
    import torch

    if not masked:
        return None
    mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
    mask[::3, 150:] = True
    return mask


def main() -> int:
    import torch

    from avex_tpu_torch.ops import attention_kernels as ak

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    groups = set(sys.argv[1:]) or {"gated", "forward", "backward", "dbias"}
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    if "gated" in groups:
        bsz, seq = 128, 248
        qkv = torch.randn(bsz, seq, 3 * E, device="cuda", generator=gen).bfloat16()
        bias = torch.randn(H, seq, seq, device="cuda", generator=gen)
        gate = (torch.rand(bsz, seq, H, device="cuda", generator=gen) + 1).permute(0, 2, 1)  # as BEATs hands it
        q, k, v = ak._split_heads(qkv, H)
        want = ak.fused_qkv_gated_reference(qkv, H, bias, gate)
        out = torch.empty(bsz, seq, E, dtype=torch.bfloat16, device="cuda")
        o = out.view(bsz, seq, H, D).permute(0, 2, 1, 3)
        strides = (ctypes.c_longlong * 20)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                                           *bias.stride(), *gate.stride(), 0, 0)
        flops = 4.0 * bsz * H * seq * seq * D
        for n, shape in enumerate(GATED_SHAPES):
            def call(n=n):
                return lib.shape_gated_forward(n, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                               gate.data_ptr(), None, o.data_ptr(), bsz, H, seq, D**-0.5, strides,
                                               stream)
            err = call()
            torch.cuda.synchronize()
            ms = median_ms(call)
            print(f"gated forward BEATs B={bsz} T={seq} <{shape}>: launch {err}, rel L2 {rel_l2(out, want):.3e}, "
                  f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
        del qkv, bias, gate, want, out
    for label, bsz, seq, masked in (("EAT", 128, 513, False), ("AVES", 128, 249, True)):
        if "forward" not in groups:
            break
        qkv = torch.randn(bsz, seq, 3 * E, device="cuda", generator=gen).bfloat16()
        mask = padding(bsz, seq, masked)
        q, k, v = ak._split_heads(qkv, H)
        want = ak.fused_qkv_reference(qkv, H, mask)
        out = torch.empty(bsz, seq, E, dtype=torch.bfloat16, device="cuda")
        o = out.view(bsz, seq, H, D).permute(0, 2, 1, 3)
        pad_strides = mask.stride() if mask is not None else (0, 0)
        strides = (ctypes.c_longlong * 14)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                                           *pad_strides)
        flops = 4.0 * bsz * H * seq * seq * D
        for n, shape in enumerate(FORWARD_SHAPES):
            def call(n=n):
                return lib.shape_forward(n, q.data_ptr(), k.data_ptr(), v.data_ptr(), ak._ptr(mask), o.data_ptr(),
                                         bsz, H, seq, D**-0.5, strides, stream)
            err = call()
            torch.cuda.synchronize()
            ms = median_ms(call)
            print(f"forward {label} B={bsz} T={seq} <{shape}>: launch {err}, rel L2 {rel_l2(out, want):.3e}, "
                  f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
        del qkv, want, out
    for label, bsz, seq, masked in (("EAT", 64, 513, False), ("AVES", 64, 249, True)):
        if "backward" not in groups:
            break
        qkv = torch.randn(bsz, seq, 3 * E, device="cuda", generator=gen).bfloat16()
        dout = torch.randn(bsz, seq, E, device="cuda", generator=gen).bfloat16()
        mask = padding(bsz, seq, masked)
        out, (lse, rest) = ak._kernel_fused(qkv, H, None, None, mask, D**-0.5, with_residuals=True)
        want = ak.fused_qkv_backward_reference(qkv, H, mask, dout)
        q, k, v = ak._split_heads(qkv, H)
        o, r, do = (t.view(bsz, seq, H, D).permute(0, 2, 1, 3) for t in (out, rest, dout))
        dqkv = torch.empty_like(qkv)
        dq, dk, dv = ak._split_heads(dqkv, H)
        delta = torch.empty(bsz, H, seq, device="cuda")
        pad_strides = mask.stride() if mask is not None else (0, 0)
        strides = (ctypes.c_longlong * 26)(*(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]),
                                           *pad_strides)
        flops = 10.0 * bsz * H * seq * seq * D
        for n, shape in enumerate(BACKWARD_SHAPES):
            def call(n=n):
                return lib.shape_backward(n, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), r.data_ptr(),
                                          do.data_ptr(), ak._ptr(mask), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                          dv.data_ptr(), delta.data_ptr(), bsz, H, seq, D**-0.5, strides, stream)
            err = call()
            torch.cuda.synchronize()
            ms = median_ms(call)
            print(f"backward {label} B={bsz} T={seq} dQ <{shape[0]}> dK/dV <{shape[1]}>: launch {err}, "
                  f"rel L2 {rel_l2(dqkv, want):.3e}, {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
        del qkv, dout, want, out, lse, rest, dqkv
    if "dbias" in groups:
        bsz, seq = 64, 248
        qkv = torch.randn(bsz, seq, 3 * E, device="cuda", generator=gen).bfloat16().requires_grad_()
        bias = torch.randn(H, seq, seq, device="cuda", generator=gen).requires_grad_()
        gate = (torch.rand(bsz, seq, H, device="cuda", generator=gen) + 1).permute(0, 2, 1)  # as BEATs hands it
        dout = torch.randn(bsz, seq, E, device="cuda", generator=gen).bfloat16()
        out = ak.fused_qkv_gated_attention(qkv, H, bias, gate)
        *_, saved, rest, lse = out.grad_fn.saved_tensors
        (want,) = torch.autograd.grad(out, (bias,), dout)  # the whole K3's dbias
        q, k, v = ak._split_heads(qkv.detach(), H)
        o, r, do = (t.view(bsz, seq, H, D).permute(0, 2, 1, 3) for t in (saved, rest, dout))
        delta = (do.float() * (o.float() + r.float())).sum(-1).contiguous()  # Δ as the dQ kernel takes it
        dbias = torch.empty(H, seq, seq, device="cuda")
        part = torch.empty(bsz, H, seq, seq, device="cuda")  # room for one chunk an item
        views = (s for t in (q, k, v, o, do, q, k, v) for s in t.stride()[:3])
        strides = (ctypes.c_longlong * 32)(*views, 0, 0, *bias.stride(), *gate.stride())
        for n, (shape, items) in enumerate(DBIAS_SHAPES):
            def call(n=n, items=items):
                return lib.shape_dbias(n, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
                                       gate.data_ptr(), lse.data_ptr(), delta.data_ptr(), dbias.data_ptr(),
                                       part.data_ptr(), bsz, items, H, seq, D**-0.5, strides, stream)
            err = call()
            torch.cuda.synchronize()
            ms = median_ms(call)
            print(f"dbias BEATs B={bsz} T={seq} <{shape}>, {-(-bsz // items)} chunk(s) of {items} items: launch {err}, "
                  f"rel L2 to K3's dbias {rel_l2(dbias, want):.3e}, {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
