"""Configuration system (the port's own copy of
``gnss_sim_receiver_tpu.utils.config``, pure Python).

Same semantics as the reference's ``ConfigurationInterface``
(src/core/interfaces/configuration_interface.h:44-58): a flat
``Role.property=value`` key space with typed ``property(name, default)``
accessors, backed either by a GNSS-SDR-style conf file
(``FileConfiguration``, src/core/receiver/file_configuration.cc:47) or an
in-memory dict for tests (``InMemoryConfiguration``).  Reference ``conf/``
files parse unchanged: lines are ``key=value`` with ``;`` / ``#`` comments
and optional ``[section]`` headers (ignored, as INIReader flattens them).
"""

from __future__ import annotations

from pathlib import Path


class Configuration:
    """Typed key/value configuration with reference-compatible accessors."""

    def __init__(self, properties: dict[str, str] | None = None):
        self._props: dict[str, str] = dict(properties or {})

    # -- mutation (InMemoryConfiguration::set_property equivalent) ----------
    def set_property(self, key: str, value) -> None:
        self._props[key] = str(value)

    def supersede_property(self, key: str, value) -> None:
        self._props[key] = str(value)

    def is_present(self, key: str) -> bool:
        return key in self._props

    # -- typed accessors ----------------------------------------------------
    def property(self, key: str, default):
        """Return the property converted to type(default); default if absent
        or malformed (string_converter.cc semantics)."""
        raw = self._props.get(key)
        if raw is None:
            return default
        raw = raw.strip()
        try:
            if isinstance(default, bool):
                return raw.lower() in ("true", "1", "yes", "on")
            if isinstance(default, int):
                return int(raw, 0)
            if isinstance(default, float):
                return float(raw)
            return raw
        except ValueError:
            return default

    def keys(self):
        return self._props.keys()

    def items(self):
        return self._props.items()


class InMemoryConfiguration(Configuration):
    """Test configuration built by set_property calls (reference
    in_memory_configuration.cc)."""


class FileConfiguration(Configuration):
    """Parse a GNSS-SDR conf file (reference file_configuration.cc:47 via
    INIReader): ``key=value`` lines, ``;``/``#`` comments, sections ignored."""

    def __init__(self, path: str | Path):
        super().__init__()
        self.path = Path(path)
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line or line[0] in ";#[":
                continue
            # strip trailing comments
            for c in (";", "#"):
                pos = line.find(c)
                if pos >= 0:
                    line = line[:pos].rstrip()
            if "=" not in line:
                continue
            key, _, value = line.partition("=")
            self._props[key.strip()] = value.strip()
