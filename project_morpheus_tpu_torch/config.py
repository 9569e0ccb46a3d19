"""Layered env-file configuration (port of config.py; reference
Morpheus_Client/config.py).

Precedence on read: OS environment > ``.env`` > ``.env.example``; startup
additionally consults ``~/.morpheus_tpu/config`` (reference
scripts/start.py:38-44 ordering).  ``save_config`` mirrors values to both
``.env`` and the home config with int/float coercion, and patches
``os.environ`` so live modules observe the change.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Union

ENV_FILE = ".env"
ENV_EXAMPLE_FILE = ".env.example"
HOME_CONFIG = Path.home() / ".morpheus_tpu" / "config"

DEFAULTS: Dict[str, str] = {
    "ORPHEUS_ENGINE_MODE": "torch",
    "ORPHEUS_MODEL_SIZE": "tiny",
    "ORPHEUS_MAX_TOKENS": "8192",
    "ORPHEUS_TEMPERATURE": "0.6",
    "ORPHEUS_TOP_P": "0.9",
    "ORPHEUS_SAMPLE_RATE": "24000",
    "ORPHEUS_MAX_SLOTS": "8",
    "ORPHEUS_MAX_SEQ": "2048",
    "ORPHEUS_HOST": "0.0.0.0",
    "ORPHEUS_PORT": "5005",
}

Value = Union[str, int, float, bool]


def _parse_env_file(path: Union[str, Path]) -> Dict[str, str]:
    result: Dict[str, str] = {}
    p = Path(path)
    if not p.exists():
        return result
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        result[key.strip()] = val.strip().strip('"').strip("'")
    return result


def ensure_env_file_exists(base_dir: Union[str, Path] = ".") -> Path:
    """Bootstrap ``.env`` from ``.env.example`` (config.py:9-34)."""
    base = Path(base_dir)
    env = base / ENV_FILE
    example = base / ENV_EXAMPLE_FILE
    if not env.exists():
        if example.exists():
            env.write_text(example.read_text(encoding="utf-8"), encoding="utf-8")
        else:
            env.write_text(
                "\n".join(f"{k}={v}" for k, v in DEFAULTS.items()) + "\n",
                encoding="utf-8",
            )
    return env


def get_current_config(base_dir: Union[str, Path] = ".") -> Dict[str, str]:
    """Merged view honouring precedence env > ~/.morpheus_tpu/config >
    .env > .env.example > defaults."""
    base = Path(base_dir)
    merged: Dict[str, str] = dict(DEFAULTS)
    merged.update(_parse_env_file(base / ENV_EXAMPLE_FILE))
    merged.update(_parse_env_file(base / ENV_FILE))
    merged.update(_parse_env_file(HOME_CONFIG))
    for key in list(merged):
        if key in os.environ:
            merged[key] = os.environ[key]
    return merged


def _coerce(val: Value) -> str:
    if isinstance(val, bool):
        return "true" if val else "false"
    if isinstance(val, float) and val == int(val):
        return str(int(val))
    return str(val)


def save_config(
    updates: Dict[str, Value],
    base_dir: Union[str, Path] = ".",
    home_config: Optional[Path] = None,
) -> Dict[str, str]:
    """Persist ``updates`` to .env and the home config; patch os.environ."""
    base = Path(base_dir)
    env_path = ensure_env_file_exists(base)
    current = _parse_env_file(env_path)
    for key, val in updates.items():
        current[key] = _coerce(val)
    env_path.write_text(
        "\n".join(f"{k}={v}" for k, v in sorted(current.items())) + "\n",
        encoding="utf-8",
    )
    home = home_config or HOME_CONFIG
    home.parent.mkdir(parents=True, exist_ok=True)
    home_vals = _parse_env_file(home)
    home_vals.update({k: _coerce(v) for k, v in updates.items()})
    home.write_text(
        "\n".join(f"{k}={v}" for k, v in sorted(home_vals.items())) + "\n",
        encoding="utf-8",
    )
    for key, val in updates.items():
        os.environ[key] = _coerce(val)
    return current
