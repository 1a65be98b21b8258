#!/usr/bin/env python3
"""Time ATST's frontend on the card, from one checkout.

    python3 scripts/torch_frontend_time.py [CHECKOUT]

Imports ``avex_tpu_torch`` from CHECKOUT (default: this one) and runs
``models.atst.atst_frontend`` on B=128 clips of 10 s at 16 kHz in both
precisions: ``"default"`` (the bf16 model's: bf16-rounded DFT operands, fp32
sums) and ``"highest"`` (fp32). Prints one line ``FRONTEND <checkout>
default_ms=.. highest_ms=.. default_host_ms=.. highest_host_ms=..
default_rel=.. highest_rel=..``:

- ``*_ms``: device time, the median of 20 calls, each queued behind a sleep
  kernel between two CUDA events (gaps the host leaves on the stream count);
- ``*_host_ms``: the host's time to issue one call while the stream is still
  busy with a sleep kernel: a call that waits for the stream (a copy from
  pageable host memory) takes about as long as that sleep;
- ``*_rel``: the card's output against the CPU's (rel L2, B=8).

Two checkouts are compared on one card by running it on each in turns
(parent, change, change, parent), e.g. with the parent unpacked by
``git archive`` into ``build/parent``. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(CHECKOUT))
B, SAMPLES = 128, 10 * 16000
N = 20
SLEEP_CYCLES = 4_000_000


def main() -> int:
    import torch

    from avex_tpu_torch.models.atst import atst_frontend

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    wav = torch.randn(B, SAMPLES, device="cuda", generator=gen) * 0.1
    out = {}
    for precision in ("default", "highest"):
        def call():
            return atst_frontend(wav, precision)

        call()
        call()
        torch.cuda.synchronize()
        events, host = [], []
        for _ in range(N):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            events.append((start, end))
            torch.cuda.synchronize()
        out[f"{precision}_ms"] = statistics.median(s.elapsed_time(e) for s, e in events)
        out[f"{precision}_host_ms"] = statistics.median(host)
        small = wav[:8]
        got, want = atst_frontend(small, precision).cpu(), atst_frontend(small.cpu(), precision)
        out[f"{precision}_rel"] = float((got - want).norm() / want.norm())
    print(f"FRONTEND {CHECKOUT} ({card}) " + " ".join(f"{k}={v:.6g}" for k, v in out.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
