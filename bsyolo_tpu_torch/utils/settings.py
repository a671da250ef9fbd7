"""User settings (counterpart of ``bsyolo_tpu/utils/settings.py``).

Both packages share one JSON file, ``~/.config/bsyolo_tpu/settings.json``,
with the same keys and defaults, ``compilation_cache_dir`` (read by the JAX
package only) included, so the file stays valid for both. ``datasets_dir``
is the root against which a bundled dataset config (``car.yaml``: ``path:
../datasets/car``) resolves.
"""

from __future__ import annotations

import json
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

SETTINGS_VERSION = "0.1.0"


def settings_file() -> Path:
    """The shared settings file under the current user's home."""
    return Path.home() / ".config" / "bsyolo_tpu" / "settings.json"


def _defaults(root: Path) -> Dict[str, Any]:
    return {
        "settings_version": SETTINGS_VERSION,
        "uuid": uuid.uuid4().hex,
        "datasets_dir": str(root / "datasets"),
        "weights_dir": str(root / "weights"),
        "runs_dir": str(root / "runs"),
        "tensorboard": True,
        "jsonl": True,
        "sync": False,  # no telemetry
        "compilation_cache_dir": str(root.parent / "bsyolo_tpu" / "jax_cache"),  # the JAX package's
    }


def datasets_dir(file: Optional[Path] = None) -> Path:
    """The settings' ``datasets_dir``, or the default beside the settings file; reads the file, never
    writes it."""
    file = Path(file or settings_file())
    try:
        value = json.loads(file.read_text()).get("datasets_dir")
    except (OSError, ValueError, AttributeError):
        value = None
    return Path(value) if value else file.parent.parent / "bsyolo_tpu_data" / "datasets"


class SettingsManager(dict):
    """The settings as a dict, written to ``file`` (the shared file by default) when read and at every
    change, as the JAX package's: created with the defaults where it is absent, its known keys kept and
    the rest refreshed when its ``settings_version`` is another, reset when it is no JSON object.
    ``update`` and item assignment take only keys the settings have (SyntaxError otherwise, as the JAX
    command line raises); ``reset`` writes the defaults back."""

    def __init__(self, file: Optional[str] = None):
        super().__init__()
        self.file = Path(file or settings_file())
        self._defaults = _defaults(self.file.parent.parent / "bsyolo_tpu_data")
        dict.update(self, self._defaults)
        if not self.file.exists():
            self.save()
            return
        try:
            stored = json.loads(self.file.read_text())
        except ValueError:
            stored = None
        if not isinstance(stored, dict):
            self.reset()
        elif stored.get("settings_version") == SETTINGS_VERSION:
            dict.update(self, stored)
            self.save()
        else:
            dict.update(self, {k: v for k, v in stored.items() if k in self._defaults and k != "settings_version"})
            self.save()

    def save(self) -> None:
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(json.dumps(dict(self), indent=2))

    def _check(self, keys) -> None:
        unknown = [k for k in keys if k not in self]
        if unknown:
            raise SyntaxError(f"unknown settings key(s) {unknown}; valid: {sorted(self)}")

    def update(self, *args, **kwargs) -> None:
        new = dict(*args, **kwargs)
        self._check(new)
        super().update(new)
        self.save()

    def __setitem__(self, key, value) -> None:
        self._check([key])
        super().__setitem__(key, value)
        self.save()

    def reset(self) -> None:
        self.clear()
        dict.update(self, self._defaults)
        self.save()
