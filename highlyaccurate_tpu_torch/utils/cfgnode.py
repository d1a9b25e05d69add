"""Minimal YACS-style configuration node (a copy of
``highlyaccurate_tpu/utils/cfgnode.py``; no framework).

Capability-parity replacement for the reference's vendored CfgNode
(reference cfgnode.py:36-507).  In the reference it is used only to parse
the Ford calibration YAMLs (Ford_dataset.py:118-137); this implementation
covers that plus the standard merge/freeze workflow in a fraction of the
code.  ``yaml`` is imported only where a file is read.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional


class CfgNode(dict):
    """A dict with attribute access, optional immutability, YAML IO and merge."""

    _IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Optional[Dict] = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode._IMMUTABLE, False)
        for k, v in init_dict.items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} on an immutable CfgNode")
        self[name] = CfgNode(value) if isinstance(value, dict) and \
            not isinstance(value, CfgNode) else value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, CfgNode._IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {key} on an immutable CfgNode")
        super().__setitem__(key, value)

    # -- immutability -------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode._IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- IO / merge ---------------------------------------------------------
    @classmethod
    def load_yaml(cls, path: str) -> "CfgNode":
        import yaml
        with open(path) as f:
            return cls(yaml.safe_load(f))

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        for k, v in other.items():
            if k in self and isinstance(self[k], CfgNode) \
                    and isinstance(v, (dict, CfgNode)):
                self[k].merge_from_other_cfg(CfgNode(v))
            else:
                self[k] = copy.deepcopy(v)

    def merge_from_file(self, path: str) -> None:
        self.merge_from_other_cfg(CfgNode.load_yaml(path))

    def merge_from_list(self, opts: List) -> None:
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"
