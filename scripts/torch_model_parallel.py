"""``chip_smoke.py`` phase 31 with (d), dp x tp on four ranks, on one card.

Runs phase 31's cases on gloo ranks sharing card 0 (NCCL takes no two ranks
on one card), each fp32 step held to the one-process step: (a) TP=2 BEATs,
(b) GPipe over BEATs and EAT (2 stages, 4 microbatches), (c) SP + TP
BEATs, then (d) dp x tp on a 2 x 2 mesh of four ranks, which the smoke run
leaves out for time::

    python3 scripts/torch_model_parallel.py

Prints the checks and one JSON line, as ``chip_smoke.py`` does; exits 1
when a check failed.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    chip_smoke.phase_model_parallel(ROOT / "build" / "model_parallel", dp_tp=True)
    if chip_smoke.FAILURES:
        print(f"{len(chip_smoke.FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
