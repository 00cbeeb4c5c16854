"""Copy a flax variables dict into the port's modules.

The port's submodules carry the flax modules' names, so a flax leaf path maps
onto a torch parameter name by three rules:

* the inner ``Conv_0`` or ``Dense_0`` of a layer that holds its parameters
  directly (``Conv1dSame``, ``PatchEmbed1D``, ``TorchLinear``: the class's
  ``FLAX_WRAPPER``) drops out of the path;
* ``kernel`` becomes ``weight``: a conv kernel (K, C_in, C_out) is stored as
  (C_out, C_in, K), a Dense kernel (in, out) as (out, in);
* LayerNorm's ``scale`` becomes ``weight``; ``bias`` and CosineLinear's
  (in, out) ``weight`` keep name and layout.

The loader always copies (no tensor shares memory with the caller's arrays)
and raises on a missing or extra leaf and on a shape that does not fit.
``export_flax_params`` is its inverse: a module's parameters (or gradients,
or momentum buffers) as a flax variables dict of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _torch_leaf(module: nn.Module, path: tuple, value) -> tuple:
    """(torch parameter name, array in the torch layout) of one flax leaf of
    ``module``'s tree: a path element drops out where it names the
    ``FLAX_WRAPPER`` of the module that owns it."""
    arr = np.array(value, dtype=np.float32, copy=True)
    *path_mods, leaf = path
    mods, owner = [], module
    for p in path_mods:
        if owner is not None and getattr(owner, "FLAX_WRAPPER", None) == p:
            continue
        mods.append(p)
        owner = dict(owner.named_children()).get(p) if owner is not None else None
    if leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"kernel {'/'.join(path)} has unexpected rank {arr.ndim}")
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mods + [leaf]), np.ascontiguousarray(arr)


def load_flax_params(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy ``variables`` ({"params": {...}} of numpy-convertible arrays) into
    ``module`` in place and return it."""
    if "params" not in variables:
        raise ValueError("expected a flax variables dict with a 'params' collection")
    leaves = dict(_torch_leaf(module, p, v) for p, v in _flatten(variables["params"]).items())
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(leaves))
    extra = sorted(set(leaves) - set(own))
    if missing or extra:
        raise ValueError(f"flax params do not fit {type(module).__name__}: "
                         f"missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, param in own.items():
            src = leaves[name]
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{name}: flax shape {src.shape} (torch layout) "
                                 f"!= port shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(src))
    return module


def _flax_leaf(module: nn.Module, name: str, value: torch.Tensor) -> tuple:
    """(flax leaf path, array in the flax layout) of one torch parameter:
    the inverse of ``_torch_leaf``."""
    *mods, leaf = name.split(".")
    owner = module.get_submodule(".".join(mods)) if mods else module
    arr = value.detach().cpu().numpy().astype(np.float32, copy=True)
    wrapper = getattr(owner, "FLAX_WRAPPER", None)
    if wrapper is not None and leaf in ("weight", "bias"):
        if leaf == "weight":
            leaf = "kernel"
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        return tuple(mods) + (wrapper, leaf), np.ascontiguousarray(arr)
    if isinstance(owner, nn.LayerNorm) and leaf == "weight":
        leaf = "scale"
    return tuple(mods) + (leaf,), arr


def export_flax_params(module: nn.Module,
                       tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """A flax variables dict ({"params": {...}} of numpy arrays) of
    ``module``'s parameters: the inverse of ``load_flax_params``.

    ``tensors`` maps the module's parameter names to tensors of their shapes
    (gradients, momentum buffers) to export in the same layout instead; by
    default the parameters themselves. Always copies."""
    own = dict(module.named_parameters())
    values = own if tensors is None else dict(tensors)
    if set(values) != set(own):
        raise ValueError(f"tensors do not fit {type(module).__name__}: "
                         f"missing {sorted(set(own) - set(values))}, "
                         f"extra {sorted(set(values) - set(own))}")
    tree: Dict[str, Any] = {}
    for name, value in values.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(own[name].shape)}")
        path, arr = _flax_leaf(module, name, value)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return {"params": tree}
