"""Two-level YAML config (port of ``nope_nerf_tpu/config.py``).

A scene YAML is merged recursively over ``configs/default.yaml``; the
schema is the JAX package's, so every config in ``configs/`` loads here
unchanged. Kept in the port (not imported from the JAX package) so that a
program on a machine without JAX imports nothing of it.
"""
from __future__ import annotations

import os
import warnings

import yaml

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(_REPO_DIR, "configs", "default.yaml")

# what tpu.parity: True expands to (the JAX package's PARITY_PROFILE); in
# the port mlp_bf16 / use_pallas_mlp False select the f32 unfused renderer
PARITY_PROFILE = {
    "fast_ray_sampling": False,
    "chamfer_mode": "exact",
    "eager_metrics": True,
    "mlp_bf16": False,
    "use_pallas_mlp": False,
}
_PARITY_STOCK = {"fast_ray_sampling": True, "chamfer_mode": "auto"}


def load_config(path: str, default_path: str | None = None) -> dict:
    """Load ``path`` merged over ``default_path`` (the packaged defaults
    when None)."""
    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f) or {}
    if default_path is None:
        default_path = DEFAULT_CONFIG
    cfg = {}
    if default_path and os.path.exists(default_path):
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f) or {}
    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dict1: dict, dict2: dict) -> None:
    """Recursively merge ``dict2`` into ``dict1`` in place."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def apply_parity_profile(cfg) -> dict:
    """Expand ``tpu.parity: True`` into :data:`PARITY_PROFILE` in place,
    warning where it overrides a value that was set on purpose."""
    tpu = cfg.setdefault("tpu", {})
    if not tpu.get("parity", False):
        return cfg
    for k, v in PARITY_PROFILE.items():
        if k in tpu and tpu[k] != v and tpu[k] != _PARITY_STOCK.get(k, v):
            warnings.warn(
                f"tpu.parity overrides explicit tpu.{k}={tpu[k]!r} -> {v!r}",
                stacklevel=2)
        tpu[k] = v
    return cfg


def check_supported(cfg) -> None:
    """Reject configurations the reference itself cannot run (the JAX
    package's ``check_supported``)."""
    nt = (cfg.get("model", {}) or {}).get("network_type", "official")
    if nt != "official":
        raise ValueError(f"model.network_type={nt!r}: only 'official' exists")
    tr = cfg.get("training", {}) or {}
    mm = tr.get("match_method", "dense")
    if mm != "dense":
        raise ValueError(f"training.match_method={mm!r}: only 'dense' exists")
    if (tr.get("validate_every") or 0) > 0:
        warnings.warn("training.validate_every > 0 is ignored (the "
                      "reference's validation branch is non-functional)",
                      stacklevel=2)
    tpu = cfg.get("tpu", {}) or {}
    mp = tpu.get("matmul_precision", "default")
    if mp not in ("default", "high", "highest"):
        raise ValueError(f"tpu.matmul_precision={mp!r}: must be 'default', "
                         "'high' or 'highest' (lowercase)")
    if mp != "default":
        warnings.warn("tpu.matmul_precision has no effect in the port: its "
                      "f32 matmuls always run in full f32 (TF32 off) and "
                      "the kernels in bf16", stacklevel=2)
    cm = tpu.get("chamfer_mode", "exact")
    if cm not in ("exact", "band", "grid", "auto"):
        raise ValueError(f"tpu.chamfer_mode={cm!r}: must be 'exact', 'band', "
                         "'grid' or 'auto'")
    dcw = tr.get("depth_consistency_weight", 0.0) or 0.0
    dcw = dcw if isinstance(dcw, (list, tuple)) else [dcw]
    if any(float(v) != 0.0 for v in dcw):
        raise ValueError("training.depth_consistency_weight != 0 is "
                         "unsupported: the reference crashes on this path")
