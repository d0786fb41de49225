"""Typed config infrastructure.

A copy of ``deepspeed_tpu/runtime/config_utils.py``,
kept in the port so that it imports nothing of the JAX package.

Capability parity with the reference's ``runtime/config_utils.py``
(``DeepSpeedConfigModel``): dict/JSON → typed config objects with unknown-key
warnings, deprecated-key migration, and ``"auto"`` passthrough — implemented with
stdlib dataclasses (no pydantic dependency).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Any, ClassVar, Dict, Optional, Type, TypeVar

from ..utils.logging import logger

T = TypeVar("T", bound="ConfigModel")

AUTO = "auto"


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value == AUTO


@dataclass
class ConfigModel:
    """Base class: construct from a dict, tolerating unknown keys (warn) and
    recursively constructing nested ConfigModel fields.

    Subclasses may define a class attribute ``_DEPRECATED = {"old_key":
    "new_key"}`` for key migration.
    """

    _DEPRECATED: ClassVar[Dict[str, str]] = {}

    @classmethod
    def from_dict(cls: Type[T], d: Optional[Dict[str, Any]]) -> T:
        d = dict(d or {})
        for old, new in cls._DEPRECATED.items():
            if old in d:
                logger.warning(f"Config key '{old}' is deprecated; use '{new}'")
                d.setdefault(new, d.pop(old))
        known = {f.name: f for f in fields(cls)}
        kwargs = {}
        for key, value in d.items():
            if key not in known:
                logger.warning(f"{cls.__name__}: unknown config key '{key}' (ignored)")
                continue
            ftype = known[key].type
            sub = _resolve_config_model(ftype)
            if sub is not None and isinstance(value, dict):
                value = sub.from_dict(value)
            kwargs[key] = value
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, ConfigModel) else v
        return out


_MODEL_REGISTRY: Dict[str, Type[ConfigModel]] = {}


def _resolve_config_model(ftype: Any) -> Optional[Type[ConfigModel]]:
    """Map a dataclass field annotation to a ConfigModel subclass, if any.

    Annotations may be actual classes or strings (``from __future__ import
    annotations``); registered subclasses are looked up by name.
    """
    if isinstance(ftype, type) and issubclass(ftype, ConfigModel):
        return ftype
    name = ftype if isinstance(ftype, str) else getattr(ftype, "__name__", None)
    if isinstance(name, str):
        name = name.replace("Optional[", "").rstrip("]")
        return _MODEL_REGISTRY.get(name)
    return None


def register_config_model(cls: Type[ConfigModel]) -> Type[ConfigModel]:
    """Decorator registering a ConfigModel so string annotations resolve to it."""
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls


def get_scalar_param(d: Dict[str, Any], key: str, default: Any) -> Any:
    return d.get(key, default)
