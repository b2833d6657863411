"""Typed config kernel.

Port of ``cruise_control_tpu/core/config.py`` (pure Python, copied whole but
for :func:`resolve_class`): the counterpart of the reference's Kafka-style
config registry
(``cruise-control-core/src/main/java/com/linkedin/cruisecontrol/common/config/ConfigDef.java``
and ``AbstractConfig.java``): typed keys with defaults, validators, importance and
per-key docs; unknown-key tolerance; ``Password`` redaction; and config-instantiated
plugin classes (``AbstractConfig.getConfiguredInstance`` — used throughout the
reference, e.g. ``KafkaCruiseControl.java:121``).

Python-idiomatic rather than a Java translation: a ``ConfigDef`` is a plain registry of
``ConfigKey`` dataclasses; ``Config`` resolves a raw dict against it.  Grouped constants
live in :mod:`cruise_control_tpu_torch.core.config_defs` (the equivalent of the reference's
``config/constants/`` package).

:func:`resolve_class` never imports the JAX package: a dotted path into
``cruise_control_tpu.`` raises :class:`ConfigException` naming the port's
counterpart, so a properties file written for the JAX service fails loudly
here instead of loading JAX beside the port.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence


class ConfigException(Exception):
    """Invalid config definition or value (reference: ConfigException.java)."""


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class Type(enum.Enum):
    BOOLEAN = "boolean"
    STRING = "string"
    INT = "int"
    LONG = "long"          # kept distinct for doc parity; parses like INT
    DOUBLE = "double"
    LIST = "list"          # comma-separated string or python list
    CLASS = "class"        # dotted path "pkg.mod.ClassName" or a class object
    PASSWORD = "password"  # redacted in str()/to_dict()


class Password:
    """Opaque secret wrapper; never prints its value (ConfigDef.Type.PASSWORD)."""

    HIDDEN = "[hidden]"

    def __init__(self, value: str):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return self.HIDDEN

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Password) and other.value == self.value

    def __hash__(self) -> int:
        return hash(self.value)


_NO_DEFAULT = object()


def in_range(lo: Optional[float] = None, hi: Optional[float] = None) -> Callable[[str, Any], None]:
    """Range validator (reference: ConfigDef.Range.between/atLeast)."""

    def _validate(name: str, value: Any) -> None:
        if value is None:
            return
        if lo is not None and value < lo:
            raise ConfigException(f"{name}: value {value} must be >= {lo}")
        if hi is not None and value > hi:
            raise ConfigException(f"{name}: value {value} must be <= {hi}")

    return _validate


def in_values(*allowed: Any) -> Callable[[str, Any], None]:
    """Enumerated-value validator (reference: ConfigDef.ValidString.in)."""

    def _validate(name: str, value: Any) -> None:
        if value not in allowed:
            raise ConfigException(f"{name}: value {value!r} not in {allowed!r}")

    return _validate


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    type: Type
    default: Any
    importance: Importance
    doc: str
    validator: Optional[Callable[[str, Any], None]] = None

    @property
    def has_default(self) -> bool:
        return self.default is not _NO_DEFAULT


class ConfigDef:
    """Registry of config keys; supports composition via :meth:`merge`."""

    def __init__(self) -> None:
        self._keys: Dict[str, ConfigKey] = {}

    def define(
        self,
        name: str,
        type: Type,
        default: Any = _NO_DEFAULT,
        importance: Importance = Importance.MEDIUM,
        doc: str = "",
        validator: Optional[Callable[[str, Any], None]] = None,
    ) -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"Config key {name} defined twice")
        key = ConfigKey(name, type, default, importance, doc, validator)
        if key.has_default and key.default is not None:
            parsed = _parse_value(key, key.default)
            if validator is not None:
                validator(name, parsed)
        self._keys[name] = key
        return self

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for k in other._keys.values():
            if k.name not in self._keys:
                self._keys[k.name] = k
        return self

    def keys(self) -> Mapping[str, ConfigKey]:
        return dict(self._keys)

    def names(self) -> List[str]:
        return list(self._keys)

    def parse(self, props: Mapping[str, Any]) -> Dict[str, Any]:
        values: Dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = _parse_value(key, props[name])
            elif key.has_default:
                value = None if key.default is None else _parse_value(key, key.default)
            else:
                raise ConfigException(f"Missing required configuration '{name}'")
            if key.validator is not None and value is not None:
                key.validator(name, value)
            values[name] = value
        return values

    def doc_table(self) -> str:
        """Markdown doc table, the equivalent of ConfigDef.toHtmlTable()."""
        lines = ["| name | type | default | importance | doc |", "|---|---|---|---|---|"]
        for k in sorted(self._keys.values(), key=lambda k: (k.importance.value, k.name)):
            default = "(required)" if not k.has_default else repr(k.default)
            lines.append(f"| {k.name} | {k.type.value} | {default} | {k.importance.value} | {k.doc} |")
        return "\n".join(lines)


def _parse_value(key: ConfigKey, raw: Any) -> Any:
    t = key.type
    try:
        if t is Type.BOOLEAN:
            if isinstance(raw, bool):
                return raw
            if isinstance(raw, str):
                low = raw.strip().lower()
                if low in ("true", "1", "yes"):
                    return True
                if low in ("false", "0", "no"):
                    return False
            raise ValueError(raw)
        if t in (Type.INT, Type.LONG):
            if isinstance(raw, bool):
                raise ValueError(raw)
            return int(raw)
        if t is Type.DOUBLE:
            if isinstance(raw, bool):
                raise ValueError(raw)
            return float(raw)
        if t is Type.STRING:
            return str(raw)
        if t is Type.LIST:
            if isinstance(raw, str):
                return [s.strip() for s in raw.split(",") if s.strip()] if raw.strip() else []
            return list(raw)
        if t is Type.CLASS:
            return raw  # resolved lazily by Config.get_configured_instance
        if t is Type.PASSWORD:
            return raw if isinstance(raw, Password) else Password(str(raw))
    except (TypeError, ValueError):
        pass
    raise ConfigException(f"{key.name}: cannot parse {raw!r} as {t.value}")


#: the JAX package's import root, which the port never imports
_JAX_PACKAGE = "cruise_control_tpu"
_PORT_PACKAGE = "cruise_control_tpu_torch"


def resolve_class(spec: Any) -> type:
    """Resolve a dotted-path string (or class object) to a class."""
    if isinstance(spec, type):
        return spec
    if not isinstance(spec, str) or "." not in spec:
        raise ConfigException(f"Cannot resolve class from {spec!r}")
    if spec.split(".", 1)[0] == _JAX_PACKAGE:
        port = _PORT_PACKAGE + spec[len(_JAX_PACKAGE):]
        raise ConfigException(
            f"Cannot resolve class {spec!r}: it names the JAX package, which the "
            f"port never imports; its counterpart is {port!r}"
        )
    module_name, _, cls_name = spec.rpartition(".")
    try:
        module = importlib.import_module(module_name)
        return getattr(module, cls_name)
    except (ImportError, AttributeError) as e:
        raise ConfigException(f"Cannot resolve class {spec!r}: {e}") from e


class Config:
    """Resolved configuration (reference: AbstractConfig.java).

    Tolerates unknown keys (kept in :attr:`originals`, reported by :meth:`unused`).
    """

    def __init__(self, definition: ConfigDef, props: Optional[Mapping[str, Any]] = None):
        props = dict(props or {})
        self.definition = definition
        self.originals: Dict[str, Any] = props
        self._values = definition.parse(props)
        self._used: set = set()

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def get(self, name: str) -> Any:
        if name not in self._values:
            raise ConfigException(f"Unknown configuration '{name}'")
        self._used.add(name)
        return self._values[name]

    # Typed accessors for call-site clarity.
    def get_int(self, name: str) -> int:
        return self.get(name)

    def get_double(self, name: str) -> float:
        return self.get(name)

    def get_boolean(self, name: str) -> bool:
        return self.get(name)

    def get_string(self, name: str) -> str:
        return self.get(name)

    def get_list(self, name: str) -> List[Any]:
        return self.get(name)

    def unused(self) -> List[str]:
        return [k for k in self.originals if k in self._values and k not in self._used]

    def unknown(self) -> List[str]:
        return [k for k in self.originals if k not in self._values]

    def _instantiate(self, key_name: str, spec: Any, expected: type, extra: Optional[Mapping[str, Any]]) -> Any:
        cls = resolve_class(spec)
        if not issubclass(cls, expected):
            raise ConfigException(f"{key_name}: {cls} is not a subclass of {expected}")
        instance = cls()
        if hasattr(instance, "configure"):
            merged = dict(self.originals)
            merged.update(extra or {})
            instance.configure(merged)
        return instance

    def get_configured_instance(self, name: str, expected: type, extra: Optional[Mapping[str, Any]] = None) -> Any:
        """Instantiate a plugin class named by config key ``name``.

        The instance's ``configure(config_dict)`` method, if present, is called with
        the full original config plus ``extra`` — mirroring the reference's
        ``getConfiguredInstance`` + ``CruiseControlConfigurable.configure`` contract.
        """
        return self._instantiate(name, self.get(name), expected, extra)

    def get_configured_instances(self, name: str, expected: type, extra: Optional[Mapping[str, Any]] = None) -> List[Any]:
        specs: Sequence[Any] = self.get(name) or []
        return [self._instantiate(name, spec, expected, extra) for spec in specs]

    def to_dict(self, redact: bool = True) -> Dict[str, Any]:
        out = {}
        for k, v in self._values.items():
            out[k] = Password.HIDDEN if (redact and isinstance(v, Password)) else v
        return out


def load_properties(path: str) -> dict:
    """Parse a java-style .properties file (``KafkaCruiseControlUtils.readConfig``;
    the JAX package keeps this function in its ``app.py``)."""
    props: dict = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith(("#", "!")):
                continue
            key, _, value = line.partition("=")
            props[key.strip()] = value.strip()
    return props
