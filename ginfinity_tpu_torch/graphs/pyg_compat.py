"""Pickle-level torch_geometric compatibility without torch_geometric.

Port of ``ginfinity_tpu/graphs/pyg_compat.py``.  The reference's
inter-tool contract for window corpora is ``windows_graphs.pt``: a dict
of PyG ``Data`` objects written with ``torch.save`` and read back with
``torch.load(..., weights_only=False)``.  Pickle records a class by its
module path and name, so stand-in classes registered under the real
``torch_geometric`` module paths in ``sys.modules`` let such a file load
here, and files written here unpickle as genuine ``Data`` objects where
PyG is installed (the same ``_store`` GlobalStorage state, holding
``_mapping`` and a ``_parent`` back-reference).

:func:`ensure_pyg` uses a ``torch_geometric`` that is already present —
a real installation, or stand-ins that another package registered — and
never replaces a class it finds: two sets of stand-ins in one process
would make pickle refuse the objects of whichever set lost its
registration.  Readers of the loaded objects go by attribute (``x``,
``edge_index``, ``edge_attr``, ...), never by class.
"""

from __future__ import annotations

import sys
import types


class BaseStorage:
    """Mirror of torch_geometric.data.storage.BaseStorage's pickle
    surface: state = {'_mapping': dict, '_parent': Data} (PyG's
    __getstate__ dereferences the parent weakref; its __setstate__
    rewraps it — the stub just keeps the strong reference)."""

    def __init__(self, mapping=None, parent=None):
        self.__dict__["_mapping"] = dict(mapping or {})
        if parent is not None:
            self.__dict__["_parent"] = parent

    def __getattr__(self, key):
        mapping = self.__dict__.get("_mapping", {})
        if key in mapping:
            return mapping[key]
        raise AttributeError(key)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # unexpected layout from a future PyG: keep it inspectable
            self.__dict__["_state"] = state


class GlobalStorage(BaseStorage):
    pass


class NodeStorage(BaseStorage):
    pass


class EdgeStorage(BaseStorage):
    pass


class Data:
    """Mirror of torch_geometric.data.data.Data's pickle surface."""

    def __init__(self, **mapping):
        store = GlobalStorage(
            {k: v for k, v in mapping.items() if v is not None}, parent=self
        )
        self.__dict__["_store"] = store
        # Real Data instances carry these class references in __dict__
        # (from the FeatureStore/GraphStore mixins); including them makes
        # the written state match what real PyG pickles contain.
        self.__dict__["_tensor_attr_cls"] = DataTensorAttr
        self.__dict__["_edge_attr_cls"] = DataEdgeAttr

    def __getattr__(self, key):
        store = self.__dict__.get("_store")
        if store is not None:
            try:
                return getattr(store, key)
            except AttributeError:
                pass
        raise AttributeError(key)

    def __setattr__(self, key, value):
        self.__dict__["_store"].__dict__["_mapping"][key] = value

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    @property
    def num_nodes(self):
        return int(self.x.shape[0])


class _OpaqueAttr:
    """Tolerant stand-in for PyG attr helper classes that may appear in
    pickles (TensorAttr/EdgeAttr variants)."""

    def __init__(self, *args, **kwargs):
        self._args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self._state = state


class DataTensorAttr(_OpaqueAttr):
    pass


class DataEdgeAttr(_OpaqueAttr):
    pass


class TensorAttr(_OpaqueAttr):
    pass


class EdgeAttr(_OpaqueAttr):
    pass


def _module(name: str) -> types.ModuleType:
    """The module registered as ``name``, registered empty if absent."""
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
    return mod


_CLASS_PATHS = {
    "torch_geometric.data.data": {
        "Data": Data,
        "DataTensorAttr": DataTensorAttr,
        "DataEdgeAttr": DataEdgeAttr,
    },
    "torch_geometric.data.storage": {
        "BaseStorage": BaseStorage,
        "GlobalStorage": GlobalStorage,
        "NodeStorage": NodeStorage,
        "EdgeStorage": EdgeStorage,
    },
    "torch_geometric.data.feature_store": {"TensorAttr": TensorAttr},
    "torch_geometric.data.graph_store": {"EdgeAttr": EdgeAttr},
}


def ensure_pyg():
    """The ``torch_geometric.data`` namespace, with ``Data``: a real
    installation's when one is importable or already loaded; otherwise
    stand-ins, registered only where no class of that name is present."""
    existing = sys.modules.get("torch_geometric")
    if existing is None or getattr(existing, "__file__", None):
        try:
            import torch_geometric.data as tgd  # a real installation

            return tgd
        except ImportError:
            pass
    tg = _module("torch_geometric")
    tg_data = _module("torch_geometric.data")
    tg.data = tg_data
    for path, cls_map in _CLASS_PATHS.items():
        mod = _module(path)
        for name, cls in cls_map.items():
            if not hasattr(mod, name):
                setattr(mod, name, cls)
        leaf = path.rsplit(".", 1)[1]
        if not hasattr(tg_data, leaf):
            setattr(tg_data, leaf, mod)
    if not hasattr(tg_data, "Data"):
        tg_data.Data = sys.modules["torch_geometric.data.data"].Data
    return tg_data


# the stand-ins pickle under the real module paths
for _path, _cls_map in _CLASS_PATHS.items():
    for _name, _cls in _cls_map.items():
        if _cls.__module__ == __name__:
            _cls.__module__ = _path
            _cls.__qualname__ = _name
