"""``chip_smoke.py``'s model-axis phases on one card: 31 with (d), and 32.

Phase 31's cases run on gloo ranks sharing card 0 (NCCL takes no two ranks
on one card), each fp32 step held to the one-process step: (a) TP=2 BEATs,
(b) GPipe over BEATs and EAT (2 stages, 4 microbatches), (c) SP + TP
BEATs, then (d) dp x tp on a 2 x 2 mesh of four ranks, which the smoke run
leaves out for time. Phase 32: ring attention (BEATs on 30 s windows; EAT,
AVES, Bird-MAE base), the expert-parallel MoE probe, Bird-MAE base's GPipe
and SP + TP steps, and the 3-D dp x pp x tp cell on four ranks::

    python3 scripts/torch_model_parallel.py          # both phases
    python3 scripts/torch_model_parallel.py 32       # phase 32 alone

Prints the checks and the phases' JSON lines, as ``chip_smoke.py`` does;
exits 1 when a check failed.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    phases = set(argv) or {"31", "32"}
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    if "31" in phases:
        chip_smoke.phase_model_parallel(ROOT / "build" / "model_parallel", dp_tp=True)
    if "32" in phases:
        chip_smoke.phase_model_axis_rest(ROOT / "build" / "model_parallel")
    if chip_smoke.FAILURES:
        print(f"{len(chip_smoke.FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
