# Copied from gnss_sdr_tpu/config/configuration.py; only the package imports are rewritten.
"""INI-dialect configuration with typed property access.

Mirrors the reference's configuration API so reference .conf files work
unmodified:

- ``ConfigurationInterface::property(name, default)`` with the default's
  type selecting the parse (src/core/interfaces/configuration_interface.h);
- ``FileConfiguration`` reads the reference INI dialect: a single
  ``[GNSS-SDR]`` section (optional), ``Role.property=value`` lines, ``;`` or
  ``#`` comments (src/core/receiver/file_configuration.cc, INIReader.cc);
- ``InMemoryConfiguration`` for tests
  (src/core/receiver/in_memory_configuration.cc).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any


_INT_PREFIX = re.compile(r"^[+-]?(0[xX][0-9a-fA-F]+|\d+)")
_FLOAT_PREFIX = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _stoi(text: str) -> int:
    """std::stoi semantics (file_configuration.cc numeric parse): consume
    the longest valid integer prefix, ignore trailing junk (reference
    confs carry values like ``8;`` or ``8; 8``)."""
    m = _INT_PREFIX.match(text.strip())
    if not m:
        raise ValueError(f"cannot parse integer from {text!r}")
    return int(m.group(0), 0)


def _stof(text: str) -> float:
    """std::stof semantics: longest valid float prefix."""
    m = _FLOAT_PREFIX.match(text.strip())
    if not m:
        raise ValueError(f"cannot parse float from {text!r}")
    return float(m.group(0))


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("true", "1", "yes", "on"):
        return True
    if t in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"cannot parse boolean from {text!r}")


class ConfigurationInterface:
    """Typed property(name, default) access over a flat key->string store."""

    def __init__(self) -> None:
        self._properties: dict[str, str] = {}

    # -- reference-compatible API ------------------------------------------
    def property(self, name: str, default: Any) -> Any:
        """Return the property parsed as the type of ``default``.

        Falls back to ``default`` when the key is absent. A malformed value
        raises ValueError (the reference silently returns the default for
        some types; we prefer loud failures).
        """
        raw = self._properties.get(name)
        if raw is None:
            return default
        if isinstance(default, bool):  # before int: bool is an int subclass
            return _parse_bool(raw)
        if isinstance(default, int):
            return _stoi(raw)
        if isinstance(default, float):
            return _stof(raw)
        return raw

    def set_property(self, name: str, value: Any) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self._properties[name] = str(value)

    def has_property(self, name: str) -> bool:
        return name in self._properties

    def keys(self):
        return self._properties.keys()

    def as_dict(self) -> dict[str, str]:
        return dict(self._properties)


class InMemoryConfiguration(ConfigurationInterface):
    """Configuration populated programmatically (used widely by tests)."""

    def __init__(self, properties: dict[str, Any] | None = None) -> None:
        super().__init__()
        for k, v in (properties or {}).items():
            self.set_property(k, v)


class FileConfiguration(ConfigurationInterface):
    """Configuration read from a reference-dialect .conf INI file."""

    def __init__(self, filename: str | Path) -> None:
        super().__init__()
        self.filename = str(filename)
        text = Path(filename).read_text()
        self._parse(text)

    def _parse(self, text: str) -> None:
        for lineno, line in enumerate(text.splitlines(), start=1):
            stripped = line.strip()
            if not stripped or stripped.startswith((";", "#")):
                continue
            if stripped.startswith("[") and stripped.endswith("]"):
                continue  # section headers are ignored (single-section dialect)
            if "=" not in stripped:
                raise ValueError(
                    f"{self.filename}:{lineno}: expected key=value, got {stripped!r}"
                )
            key, _, value = stripped.partition("=")
            # strip trailing inline comments introduced by whitespace+; or #
            for marker in (" ;", "\t;", " #", "\t#"):
                pos = value.find(marker)
                if pos != -1:
                    value = value[:pos]
            # reference confs end many values with a bare ';'
            # (e.g. "dump=false;"): the C++ numeric parse (std::stof/stoi)
            # stops at the first invalid char, so the ';' is silently
            # ignored there — match that by stripping it
            self._properties[key.strip()] = value.strip().rstrip(";").strip()
