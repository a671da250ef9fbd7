"""The part of the user settings the port reads (counterpart of ``bsyolo_tpu/utils/settings.py``).

Both packages share one JSON file, ``~/.config/bsyolo_tpu/settings.json``.
The port only reads it, and only ``datasets_dir``: the root against which a
bundled dataset config (``car.yaml``: ``path: ../datasets/car``) resolves.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

SETTINGS_FILE = Path.home() / ".config" / "bsyolo_tpu" / "settings.json"


def datasets_dir(file: Optional[Path] = None) -> Path:
    """The settings' ``datasets_dir``, or the JAX package's default beside the settings file."""
    file = Path(file or SETTINGS_FILE)
    try:
        value = json.loads(file.read_text()).get("datasets_dir")
    except (OSError, ValueError):
        value = None
    return Path(value) if value else file.parent.parent / "bsyolo_tpu_data" / "datasets"
