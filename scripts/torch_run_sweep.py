#!/usr/bin/env python
"""Grid-sweep runner of the PyTorch port (``scripts/run_sweep.py``'s copy).

Expands a sweep YAML of the form

    base_config: configs/run_configs/beats_supervised_example.yml
    grid:
      training_params.lr: [1e-3, 3e-4]
      training_params.batch_size: [32, 64]

into the cartesian product of CLI patches and runs
``python -m avex_tpu_torch.cli train`` for each, with ``run_name=sweep_<i>``.
``--dry-run`` prints the commands (``:: ...``) without running them.
"""

import argparse
import itertools
import subprocess
import sys

import yaml


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("sweep_yaml")
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args()

    with open(args.sweep_yaml) as f:
        sweep = yaml.safe_load(f)
    base = sweep["base_config"]
    grid = sweep.get("grid", {})
    keys = list(grid)
    for i, combo in enumerate(itertools.product(*(grid[k] for k in keys))):
        patches = [f"{k}={v}" for k, v in zip(keys, combo)]
        patches.append(f"run_name=sweep_{i}")
        cmd = [sys.executable, "-m", "avex_tpu_torch.cli", "train", "-c", base]
        for patch in patches:
            cmd += ["-p", patch]
        print("::", " ".join(cmd))
        if not args.dry_run:
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
