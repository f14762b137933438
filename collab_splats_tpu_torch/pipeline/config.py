"""Hierarchical YAML configuration: base <- dataset <- runtime overrides.

Counterpart of the JAX package's ``pipeline/config.py``, an own copy: the
reference's ``ConfigLoader`` / ``parse_cli_overrides``.  ``base.yaml``
defaults, per-dataset YAMLs under ``datasets/``, deep-merged with runtime
overrides on top; dot-notation CLI overrides with bool/int/float coercion.
PyYAML is imported here only, so the rest of the pipeline runs without it
(the CLI's ``--input``/``--set`` path never loads a YAML file).
"""


from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Union


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into a copy of ``base``."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class ConfigLoader:
    """Load and merge hierarchical YAML configurations.

    Priority (highest to lowest): runtime overrides > dataset config >
    base config.  Directory layout::

        <config_dir>/base.yaml
        <config_dir>/datasets/<name>.yaml
    """

    def __init__(self, config_dir: Union[str, Path]):
        self.config_dir = Path(config_dir)
        if not self.config_dir.exists():
            raise ValueError(f"Config directory not found: {config_dir}")
        base_path = self.config_dir / "base.yaml"
        if not base_path.exists():
            raise ValueError(f"base.yaml not found in {config_dir}")
        self.base_config = self._load_yaml(base_path)

    @staticmethod
    def _load_yaml(path: Path) -> Dict[str, Any]:
        import yaml

        if not path.exists():
            return {}
        with open(path) as f:
            return yaml.safe_load(f) or {}

    def load(
        self,
        dataset: Optional[str] = None,
        overrides: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        config = dict(self.base_config)
        if dataset is not None:
            dataset_path = self.config_dir / "datasets" / f"{dataset}.yaml"
            if not dataset_path.exists():
                raise ValueError(
                    f"Dataset config not found: {dataset_path}\n"
                    f"Available datasets: {self.list_datasets()}"
                )
            config = deep_merge(config, self._load_yaml(dataset_path))
        if overrides:
            config = deep_merge(config, overrides)
        return config

    def list_datasets(self) -> List[str]:
        datasets_dir = self.config_dir / "datasets"
        if not datasets_dir.exists():
            return []
        return sorted(f.stem for f in datasets_dir.glob("*.yaml"))


def parse_cli_overrides(override_strings: List[str]) -> Dict[str, Any]:
    """Parse ``key=value`` / ``section.key=value`` strings with type
    coercion (true/false -> bool, numeric -> int/float)."""
    overrides: Dict[str, Any] = {}
    for override in override_strings:
        if "=" not in override:
            raise ValueError(
                f"Invalid override: '{override}'. Expected 'key=value'"
            )
        key, raw = override.split("=", 1)
        value: Any = raw
        if raw.lower() == "true":
            value = True
        elif raw.lower() == "false":
            value = False
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = raw
        cur = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = value
    return overrides
