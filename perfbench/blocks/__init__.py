"""The model blocks the harness knows: one file a block, ``blocks/<block>.py``.

A configuration file names its block (``"block": "<name>"``), and the
harness loads ``DIR / "<name>.py"`` by path, as it loads a per-layer
metric's reader, and asks it everything that depends on the block. So a
block is added as one new file. Every function takes the layer index
``i``, so that a block whose layers differ (leading dense layers, windowed
and global layers, a share of experts) describes each of its layers.

A block file holds:

- ``dims(cfg)``: the block's sizes, a frozen dataclass built on
  ``layout.Dims``, from the configuration file;
- ``layer_leaves(m, i)``: layer i's weights (``layout.Leaf``), named as the
  port's parameters, in the order they are drawn;
- ``layer_norms(m, i, rows)``: (rows, width) of each RMSNorm launch of
  layer i over ``rows`` tokens, in order;
- ``layer(m, w, i, x, groups, prec)``: the plain reference's layer i over
  x (B, T, d) in float32, from ``reference``'s helpers and nothing of the
  port;
- ``layer_matrix_params(m, i, active)``, ``attn_width(m, i)`` and
  ``keys_seen(m, i, pos)`` (the keys a query at each position of ``pos``,
  a numpy array, sees in layer i): what ``counts`` sums layer by layer;
- ``arch_config(m, cfg, name, remat)``: the port's ``ArchConfig``, built
  through ``port``;
- ``dispatch_groups(m, B, S, new, device)``: the reference's groups of
  tokens over which a served batch's expert capacity is taken, ``[]``
  where there are none;
- ``JUDGED_WHOLE``: a served batch is judged whole, never on a sample of
  its requests (capacity taken over the batch's tokens together);
- ``TRAINABLE``: the training reference (``reference_train``) takes the
  block.
"""
from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

#: where the block files are
DIR = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9][A-Za-z0-9_-]*")
_loaded: Dict[Path, ModuleType] = {}


def load(name: str) -> ModuleType:
    """``DIR / "<name>.py"`` as a module, loaded once."""
    path = DIR / f"{name}.py"
    if path in _loaded:
        return _loaded[path]
    if not _NAME.fullmatch(name) or not path.is_file():
        found = sorted(p.stem for p in DIR.glob("*.py")
                       if not p.stem.startswith("_"))
        raise ValueError(f"unknown block {name!r}; the block files in "
                         f"{DIR}: {found}")
    mod_name = f"perfbench_block_{name.replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    _loaded[path] = mod
    return mod
