"""Typed configuration loading — a copy of ``tpu3dtk.utils.config``
(pure Python; the port keeps its own so it imports nothing of the JAX
package).  It unifies the reference's config surfaces (SURVEY §5):
per-binary program options, the dataset_settings/range DSL
(include/slam6d/scan_settings.h), the key-value ``ConfigFileHough``
files (src/shapes/ConfigFileHough.cc), and ini files like dat/config.ini.

One loader: key-value text (``Key Value`` or ``key = value`` lines,
'#'/';' comments) merged into dataclass instances by field name
(case-insensitive), with scan-range parsing ("1:10,15,20:25")."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, TypeVar

T = TypeVar("T")

__all__ = ["load_kv_file", "apply_config", "parse_scan_ranges"]


def load_kv_file(path: str) -> dict[str, str]:
    """Parse 'Key Value' / 'key = value' lines (both the Hough config
    style and ini style, sections flattened)."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#;[":
                continue
            if "=" in line:
                k, v = line.split("=", 1)
            else:
                parts = line.split(None, 1)
                if len(parts) != 2:
                    continue
                k, v = parts
            out[k.strip().lower()] = v.strip()
    return out


def _coerce(value: str, typ: Any):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def apply_config(cfg: T, kv: dict[str, str]) -> T:
    """Return a copy of dataclass ``cfg`` with matching keys applied
    (field-name match, case-insensitive, underscores ignored)."""
    fields = {
        f.name.lower().replace("_", ""): f for f in dataclasses.fields(cfg)
    }
    updates = {}
    for k, v in kv.items():
        key = k.lower().replace("_", "")
        f = fields.get(key)
        if f is None:
            continue
        try:
            updates[f.name] = _coerce(v, f.type if isinstance(f.type, type) else type(getattr(cfg, f.name)))
        except (TypeError, ValueError):
            continue
    return dataclasses.replace(cfg, **updates)


def parse_scan_ranges(spec: str) -> list[int]:
    """Multi-range scan selection DSL (ref scan_settings.h range
    parser): "1:5,8,10:12" -> [1,2,3,4,5,8,10,11,12]."""
    out: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(-?\d+)(?::(-?\d+)(?::(-?\d+))?)?$", part)
        if not m:
            raise ValueError(f"bad range component {part!r}")
        a = int(m.group(1))
        if m.group(2) is None:
            out.append(a)
            continue
        b = int(m.group(2))
        step = int(m.group(3)) if m.group(3) else 1
        out.extend(range(a, b + 1, step))
    return out
