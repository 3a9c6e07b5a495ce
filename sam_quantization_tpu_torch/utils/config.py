"""Dataset-path registry + run configuration loading.

The port's copy of ``sam_quantization_tpu/utils/config.py``. Counterpart of the reference's ``config.yml`` (dataset path registry,
config.yml:1-24) loaded by utils/exp.py — a plain YAML file mapping dataset
names to paths plus experiment defaults, with environment-variable expansion.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_CONFIG = {
    "EXPS_PATH": "./runs",
    "SBD_PATH": "./datasets/SBD",
    "GRABCUT_PATH": "./datasets/GrabCut",
    "BERKELEY_PATH": "./datasets/Berkeley",
    "DAVIS_PATH": "./datasets/DAVIS",
    "COCO_MVAL_PATH": "./datasets/COCO_MVal",
    "PASCALVOC_PATH": "./datasets/VOC2012",
    "SA1B_PATH": "./datasets/SA1B",
}


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    """Load config.yml (if present) over the defaults, expanding env vars."""
    cfg = dict(DEFAULT_CONFIG)
    candidates = [path] if path else ["config.yml", "config.yaml"]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            cfg.update(_load_yaml(cand))
            break
    return {k: os.path.expandvars(str(v)) if isinstance(v, str) else v
            for k, v in cfg.items()}


def _load_yaml(path: str) -> Dict[str, Any]:
    try:
        import yaml

        with open(path) as f:
            return yaml.safe_load(f) or {}
    except ImportError:
        # minimal "key: value" parser fallback
        out: Dict[str, Any] = {}
        for line in Path(path).read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = v.strip().strip("'\"")
        return out


def dataset_path(cfg: Dict[str, Any], name: str) -> str:
    key = f"{name.upper()}_PATH"
    if key not in cfg:
        raise KeyError(f"no path configured for dataset {name!r} ({key})")
    return cfg[key]
