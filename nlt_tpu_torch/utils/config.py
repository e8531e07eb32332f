"""Experiment configuration.

Two-tier config matching the reference's scheme (reference:
nlt/trainvali.py:38-43 for runtime flags; nlt/util/io.py:40-44 +
nlt/util/config.py for the .ini experiment config): a single-``[DEFAULT]``
``configparser`` .ini holds every experiment parameter, read with typed
getters at point of use, and the experiment name ``xname`` is a format string
interpolated from the config itself.

This module wraps ``configparser`` with a thin typed accessor so the rest of
the framework never hand-rolls ``getint``/``getboolean`` conversions, while
staying file-format-compatible with the reference's .ini files.
"""

import configparser
import os


class Config:
    """A typed view over a single-[DEFAULT]-section .ini config.

    Also accepts a plain dict for programmatic construction (tests,
    sweeps). ``None`` is spelled ``'none'``/``'None'`` in .ini files,
    matching the reference convention (reference: nlt/networks/base.py:34-40).
    """

    def __init__(self, source=None):
        self._cp = configparser.ConfigParser()
        if source is None:
            pass
        elif isinstance(source, dict):
            self._cp.read_dict({"DEFAULT": {
                k: str(v) for k, v in source.items()}})
        elif isinstance(source, configparser.ConfigParser):
            self._cp = source
        else:
            raise TypeError(type(source))

    # ---- constructors ----

    @classmethod
    def from_ini(cls, path):
        cp = configparser.ConfigParser()
        with open(path, "r") as h:
            cp.read_file(h)
        return cls(cp)

    # ---- typed getters (all over [DEFAULT]) ----

    def get(self, key, default=None):
        try:
            return self._cp.get("DEFAULT", key)
        except (configparser.NoOptionError, KeyError):
            if default is not None or self.has(key):
                return default
            raise KeyError(key)

    def get_str(self, key, default=None):
        return self.get(key, default)

    def get_int(self, key, default=None):
        v = self.get(key, None if default is None else str(default))
        return int(v)

    def get_float(self, key, default=None):
        v = self.get(key, None if default is None else str(default))
        return float(v)

    def get_bool(self, key, default=None):
        v = self.get(key, None if default is None else str(default))
        if isinstance(v, bool):
            return v
        return v.strip().lower() in ("1", "true", "yes", "on")

    def get_or_none(self, key, default="none"):
        """String getter where 'none' (any case) maps to Python None."""
        v = self.get(key, default)
        if v is None or str(v).strip().lower() == "none":
            return None
        return v

    def get_list(self, key, default=None, sep=","):
        v = self.get(key, default)
        if v is None:
            return []
        return [x.strip() for x in str(v).split(sep) if x.strip()]

    def has(self, key):
        return key in self._cp["DEFAULT"]

    def set(self, key, value):
        self._cp.set("DEFAULT", key, str(value))

    # ---- reference-parity helpers ----

    def to_dict(self):
        """All [DEFAULT] keys as a plain str->str dict; used for ``xname``
        formatting (reference: nlt/util/config.py + nlt/trainvali.py:62-63).
        """
        return dict(self._cp["DEFAULT"])

    def xname(self):
        """Experiment name: the ``xname`` format string interpolated with the
        config's own keys (reference: nlt/trainvali.py:62-65).
        """
        return self.get("xname").format(**self.to_dict())

    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as h:
            self._cp.write(h)

    # ConfigParser-style compatibility so code written against the
    # reference's API (config.get('DEFAULT', key)) ports trivially.
    def getint(self, section, key):
        return self._cp.getint(section, key)

    def getfloat(self, section, key):
        return self._cp.getfloat(section, key)

    def getboolean(self, section, key):
        return self._cp.getboolean(section, key)


def read_config(path):
    return Config.from_ini(path)


def config2dict(config):
    return config.to_dict()
