"""Console entry point printing the model registry table.

Port of ``avex_tpu/api/list_models.py`` (``avex-tpu-torch-list-models``).
"""

from __future__ import annotations


def main() -> None:
    """Print the model registry table."""
    from avex_tpu_torch.commands import list_models

    list_models()


if __name__ == "__main__":
    main()
