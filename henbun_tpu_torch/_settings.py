"""Global configuration for henbun_tpu_torch.

The same user-facing contract as the JAX package's settings: a ``henbunrc``
/ ``.henbunrc`` INI file searched in the current directory, then ``$HOME``,
then the package directory; values reachable as
``settings.<section>.<key>``; ``settings.get_settings()`` returning a
mutable copy and ``settings.temp_settings(cfg)`` scoping an override on a
frame stack.

Differences from the JAX package:
  * dtype strings map to ``torch`` dtypes; ``settings.dtypes.float_type``
    is a ``torch.dtype``.
  * the ``[tpu]`` section becomes ``[cuda]``: ``device`` (where a Model puts
    its parameters and data unless the caller names a device),
    ``use_kernels`` (the gate of the hand-written CUDA kernels),
    ``matmul_precision`` (``highest`` turns TF32 off) and ``scan_chunk``
    (optimization steps between host syncs).
"""
from __future__ import annotations

import copy
import os
from configparser import ConfigParser
from contextlib import contextmanager

import numpy as np
import torch


class Section:
    """One ``[section]`` of parsed values with attribute get/set.

    New keys may be added by plain assignment (user configs can carry keys
    the package file doesn't, e.g. custom flags read by user code)."""

    def __init__(self, values=()):
        object.__setattr__(self, "_values", dict(values))

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError("Unknown setting: %r" % name)

    def __setattr__(self, name, value):
        self._values[name] = value

    def items(self):
        return self._values.items()

    def __repr__(self):
        return "Section(%r)" % (self._values,)


class Config:
    """A full configuration: attribute access to :class:`Section` objects."""

    def __init__(self, sections=()):
        object.__setattr__(self, "_sections", {})
        for name, kv in dict(sections).items():
            self._sections[name] = (
                kv if isinstance(kv, Section) else Section(kv)
            )

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_sections")[name]
        except KeyError:
            raise AttributeError("Unknown settings section: %r" % name)

    def __setattr__(self, name, value):
        self._sections[name] = (
            value if isinstance(value, Section) else Section(value)
        )

    def items(self):
        return self._sections.items()

    def __repr__(self):
        return "Config(%r)" % (self._sections,)


class _SettingsStack:
    """The module singleton: reads proxy to the top Config frame;
    ``temp_settings`` pushes/pops frames (re-entrant, exception-safe)."""

    def __init__(self, root):
        object.__setattr__(self, "_frames", [root])

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_frames")[-1], name)

    def push(self, cfg):
        self._frames.append(cfg)

    def pop(self):
        frames = self._frames
        if len(frames) == 1:
            raise IndexError("cannot pop the base settings frame")
        return frames.pop()

    def get_settings(self):
        """A deep, independently mutable copy of the current configuration
        — edit it and activate with ``temp_settings``."""
        return copy.deepcopy(self._frames[-1])

    @contextmanager
    def temp_settings(self, cfg):
        """Scoped override: ``with settings.temp_settings(cfg): ...``."""
        self.push(cfg)
        try:
            yield cfg
        finally:
            self.pop()


_DTYPE_STRINGS = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
}
_BOOL_STRINGS = {"true": True, "false": False}


def parse(string):
    """Parse an INI value string into bool / torch dtype / int / float / str."""
    if not isinstance(string, str):
        raise ValueError("%r is not a string" % (string,))
    if string.lower() in _BOOL_STRINGS:
        return _BOOL_STRINGS[string.lower()]
    if string in _DTYPE_STRINGS:
        return _DTYPE_STRINGS[string]
    for cast in (int, float):
        try:
            return cast(string)
        except ValueError:
            pass
    return string


def read_config_file(path=None):
    """Locate and parse a henbunrc.

    With ``path``: that exact file (IOError if missing). Without: the first
    of ``henbunrc`` / ``.henbunrc`` found in cwd, then ``$HOME``, then the
    package directory (non-hidden preferred per location). Returns
    ``{section: {key: parsed value}}``."""
    cp = ConfigParser()
    if path is not None:
        if not cp.read(path):
            raise IOError("config file %s not found" % path)
    else:
        locations = [
            os.path.abspath(os.curdir),
            os.path.expanduser("~"),
            os.path.dirname(os.path.realpath(__file__)),
        ]
        done = False
        for loc in locations:
            for name in ("henbunrc", ".henbunrc"):
                if cp.read(os.path.join(loc, name)):
                    done = True
                    break
            if done:
                break
    return {
        sec: {k: parse(v) for k, v in cp.items(sec)} for sec in cp.sections()
    }


def namedtuplify(mapping):
    """Build a :class:`Config` from a nested ``{section: {key: value}}``
    dict; string leaves are parsed, already-typed leaves pass through."""
    return Config(
        {
            sec: {
                k: (parse(v) if isinstance(v, str) else v)
                for k, v in dict(kv).items()
                if k != "__name__"
            }
            for sec, kv in dict(mapping).items()
            if sec != "__name__"
        }
    )


settings = _SettingsStack(namedtuplify(read_config_file()))


def np_float(dtype=None):
    """numpy analog of the configured float type (bfloat16 maps to float32
    on the host)."""
    dtype = dtype or settings.dtypes.float_type
    if dtype == torch.bfloat16:
        return np.float32
    return torch.empty((), dtype=dtype).numpy().dtype.type


def apply_matmul_precision():
    """Pin float32 matrix products to the configured precision.

    ``highest`` turns TF32 off for matmuls and convolutions; ``high`` or
    ``medium`` hand the choice to PyTorch's float32 matmul precision."""
    prec = str(settings.cuda.matmul_precision)
    torch.set_float32_matmul_precision(prec)
    tf32 = prec != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def resolve_device(device=None):
    """The ``torch.device`` a Model lives on: ``device`` when the caller
    names one, else ``settings.cuda.device``. A CUDA device that is not
    there raises: nothing carries on silently on the CPU."""
    explicit = device is not None
    dev = torch.device(device if explicit else settings.cuda.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "henbun_tpu_torch: %s requested (%s) but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU."
            % (dev, "by the caller" if explicit else "[cuda] device in henbunrc")
        )
    apply_matmul_precision()
    return dev
