"""The reference model of a configuration.

A configuration file may name its reference module under ``"reference"``:
``benchmark/reference/<name>.py``, ``model`` where it names none. A
reference module exports

- ``MVDeTr(cfg, rig, precision="f32")``: the model in plain PyTorch, with
  the state-dict names of the program's model;
- ``warp_coords(cfg, rig, affines)``: the camera warp's source pixel
  coordinates ``[B*N, 2, Hw*Ww]`` that its forward takes;
- ``offset_bias(cfg)``: the ``sampling_offsets`` bias of the benchmark's
  initialisation, flat.

Everything that builds or runs the reference reaches it through
:func:`of`, so that a new model is new files: its configuration, its
reference module, its formulas and limits.
"""

from __future__ import annotations

import importlib
import re

DEFAULT = "model"
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def of(cfg: dict):
    """The module ``benchmark.reference.<name>`` that ``cfg`` names; refuses
    any name that is not a plain identifier."""
    name = cfg.get("reference", DEFAULT)
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"reference {name!r}: a configuration names its reference module by a plain identifier")
    return importlib.import_module(f"benchmark.reference.{name}")
