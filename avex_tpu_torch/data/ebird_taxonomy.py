"""eBird taxonomy lookup (≈ ``avex_tpu/data/ebird_taxonomy.py``).

The v2021 and v2025 code → {common_name, sci_name} mappings are packaged
under ``avex_tpu_torch/data/assets/``, so ``load_ebird_taxonomy()`` needs no
configuration. An explicit path or ``AVEX_TPU_EBIRD_TAXONOMY`` overrides the
packaged files.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

__all__ = ["SUPPORTED_VERSIONS", "ebird_code_to_name", "load", "load_ebird_taxonomy"]

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
SUPPORTED_VERSIONS = ("v2021", "v2025")


@functools.lru_cache(maxsize=4)
def load_ebird_taxonomy(path: Optional[str] = None, version: str = "v2021") -> Dict[str, Dict[str, str]]:
    """``{ebird_code: {"common_name": ..., "sci_name": ...}}`` from ``path``
    (a JSON file, or a directory holding ``ebird_taxonomy_<version>.json``),
    else ``$AVEX_TPU_EBIRD_TAXONOMY``, else the packaged release ``version``."""
    path = path or os.environ.get("AVEX_TPU_EBIRD_TAXONOMY")
    if path is None:
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(f"Unsupported eBird taxonomy version {version!r}. "
                             f"Supported: {', '.join(SUPPORTED_VERSIONS)}.")
        path = _ASSET_DIR
    if os.path.isdir(path):
        path = os.path.join(path, f"ebird_taxonomy_{version}.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(version: str = "v2021") -> Dict[str, Dict[str, str]]:
    """The reference's alias of :func:`load_ebird_taxonomy`."""
    return load_ebird_taxonomy(version=version)


def ebird_code_to_name(code: str, kind: str = "common", path: Optional[str] = None) -> str:
    """One eBird code's common (``kind="common"``) or scientific name."""
    entry = load_ebird_taxonomy(path).get(code)
    if entry is None:
        raise KeyError(f"Unknown eBird code: {code}")
    if kind == "common":
        return entry.get("common_name") or entry.get("common") or code
    return entry.get("sci_name") or entry.get("scientific") or code
