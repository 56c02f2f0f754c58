"""Config loading: YAML plus recursive default merging (port of
``ssp/utils/config.py``).

Same behaviour as the reference's ``dict_update`` (``utils/tools.py:7-22``)
and YAML-driven CLIs; the configs keep the reference schema, so the repo's
``configs/*.yaml`` work unchanged.  PyYAML is imported only by
:func:`load_config`: importing the package never needs it.
"""

from __future__ import annotations

import collections.abc
import copy
from pathlib import Path
from typing import Any, Dict, Optional, Union


def dict_update(d: Dict[str, Any], u: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``u`` into ``d`` (returns ``d``)."""
    for k, v in u.items():
        if isinstance(v, collections.abc.Mapping):
            d[k] = dict_update(d.get(k, {}) or {}, v)
        else:
            d[k] = v
    return d


def load_config(path: Union[str, Path],
                defaults: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A YAML config, merged over a deep copy of ``defaults`` when given
    (``dict_update`` merges in place, so a shallow copy would let one load
    change the caller's nested defaults)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if defaults:
        return dict_update(copy.deepcopy(defaults), cfg)
    return cfg
