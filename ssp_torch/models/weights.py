"""Weights across frameworks: the JAX package's flax checkpoints and the
reference's PyTorch state dicts.

* :func:`load_flax_npz` reads the flax-keyed npz that
  ``ssp/train/checkpoint.py::save_weights_npz`` writes (keys like
  ``params/inc/ConvBNRelu_0/Conv_0/kernel`` and
  ``batch_stats/convPa/BatchNorm_0/mean``) into the port's model.  It is
  strict, as ``load_weights_npz`` is: a missing or an unconsumed key
  raises.  The one exception mirrors the JAX ``SuperPointNet_gauss2``
  factory, which drops ``n_classes``: loading a semantic checkpoint as
  ``SuperPointNet_gauss2`` drops its ``convDS``/``convSout`` scopes.
* The port's own parameter names are the reference's
  (``inc.conv.conv.0.weight``, ``bnPa.running_mean``, …, the table of
  ``ssp/models/weights.py``), so :func:`load_reference_state_dict` is a
  strict ``load_state_dict`` of a reference ``.pth.tar`` payload, which
  :func:`load_torch_checkpoint` reads.
* :func:`state_dict_to_flax` and :func:`save_weights_npz` go the other
  way: the port's state dict as the flat flax keys of
  ``ssp/train/checkpoint.py::save_weights_npz`` (float leaves stored as
  fp16), so a checkpoint the port trains loads into the JAX package's
  ``load_weights_npz`` as into the port's :func:`load_weights`.
* :func:`load_weights` loads what a config's ``pretrained`` names: a flax
  npz or a reference checkpoint (an orbax directory needs the JAX package);
  :func:`read_state_dict` reads either as a reference-named state dict.
* ``SubpixelNet``'s decoder: ``params/up1/DoubleConv_0/ConvBNRelu_0/...`` ↔
  ``up1.conv.conv.0...`` (the reference's ``unet_parts.up``), and the bare
  1×1 ``params/outc/kernel`` ↔ ``outc.weight``.
* The MagicLeap model (``SuperPointNet_pretrained``) has no BatchNorm and
  flat scopes, ``params/conv1a/kernel`` ↔ ``conv1a.weight``: its flax npz
  (``ssp/models/weights.py::import_torch_magicleap``'s params) and its
  bare ``superpoint_v1.pth`` state dict load through the same functions.

Layout: flax conv kernels are HWIO, torch's OIHW; flax BN ``scale``/
``bias``/``mean``/``var`` are torch BN ``weight``/``bias``/
``running_mean``/``running_var``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ssp_torch._device import resolve_device
from ssp_torch.models.superpoint import build_model

# flax scope → reference prefix of the DoubleConv's Sequential; SubpixelNet's
# decoder blocks hold theirs one scope deeper (``up1/DoubleConv_0/...``)
_BLOCKS = {
    "inc": "inc.conv.conv",
    "down1": "down1.mpconv.1.conv",
    "down2": "down2.mpconv.1.conv",
    "down3": "down3.mpconv.1.conv",
    "up1": "up1.conv.conv",
    "up2": "up2.conv.conv",
    "up3": "up3.conv.conv",
}
_UP_SCOPE = "DoubleConv_0"
# flax ConvBNRelu scope → (reference conv name, reference BN name)
_HEADS = {
    "convPa": ("convPa", "bnPa"),
    "convPb": ("convPb", "bnPb"),
    "convDa": ("convDa", "bnDa"),
    "convDb": ("convDb", "bnDb"),
    "convDS": ("convDS", "bnS1"),
}
_SEMANTIC_SCOPES = ("convDS", "convSout")


def _flax_to_torch_name(key: str) -> str:
    """``params/down1/ConvBNRelu_1/Conv_0/kernel`` → ``down1.mpconv.1.conv.3.weight``."""
    kind, scope, *rest = key.split("/")
    if scope.startswith("up") and rest[:1] == [_UP_SCOPE]:
        rest = rest[1:]
    if len(rest) == 1:  # a bare conv: convSout, SubpixelNet's outc, any MagicLeap conv
        (leaf,) = rest
        prefix = scope
    elif scope in _BLOCKS:
        cbr, layer, leaf = rest
        i = int(cbr.rsplit("_", 1)[1])
        idx = 3 * i + (0 if layer == "Conv_0" else 1)
        prefix = f"{_BLOCKS[scope]}.{idx}"
    elif scope in _HEADS:
        layer, leaf = rest
        prefix = _HEADS[scope][0 if layer == "Conv_0" else 1]
    else:
        raise KeyError(f"unknown flax scope in {key!r}")
    names = {
        ("params", "kernel"): "weight", ("params", "bias"): "bias",
        ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
        ("batch_stats", "var"): "running_var",
    }
    return f"{prefix}.{names[(kind, leaf)]}"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables — flat ``params/...`` keys or the nested
    ``{"params", "batch_stats"}`` tree — → reference-named fp32 tensors
    (fp64 leaves stay fp64)."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(variables).items():
        arr = np.asarray(value)
        arr = arr.astype(np.float64 if arr.dtype == np.float64 else np.float32, copy=False)
        if key.endswith("/kernel"):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        sd[_flax_to_torch_name(key)] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _torch_to_flax_name(name: str) -> Optional[str]:
    """``down1.mpconv.1.conv.3.weight`` → ``params/down1/ConvBNRelu_1/Conv_0/kernel``
    (None for BN's ``num_batches_tracked``, which flax does not keep)."""
    prefix, leaf = name.rsplit(".", 1)
    if leaf == "num_batches_tracked":
        return None
    kind, flax_leaf = _LEAVES[leaf]
    is_bn = False
    for scope, block in _BLOCKS.items():
        if prefix.startswith(block + "."):
            i, r = divmod(int(prefix[len(block) + 1:]), 3)
            is_bn = r == 1
            inner = f"{scope}/{_UP_SCOPE}" if scope.startswith("up") else scope
            path = f"{inner}/ConvBNRelu_{i}/{'BatchNorm_0' if is_bn else 'Conv_0'}"
            break
    else:
        heads = {name: (scope, j) for scope, pair in _HEADS.items() for j, name in enumerate(pair)}
        if prefix in heads:
            scope, j = heads[prefix]
            is_bn = j == 1
            path = f"{scope}/{'BatchNorm_0' if is_bn else 'Conv_0'}"
        else:  # a bare conv: convSout, SubpixelNet's outc, any MagicLeap conv
            path = prefix
    if is_bn and leaf == "weight":
        flax_leaf = "scale"
    return f"{kind}/{path}/{flax_leaf}"


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's (reference-named) state dict → flat flax keys, fp32 numpy,
    conv kernels HWIO: the inverse of :func:`flax_to_state_dict`."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        key = _torch_to_flax_name(name)
        if key is None:
            continue
        arr = value.detach().float().cpu().numpy()
        if key.endswith("/kernel"):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW → HWIO
        flat[key] = np.ascontiguousarray(arr)
    return flat


def save_weights_npz(path: Union[str, Path], model_or_state_dict) -> Path:
    """Write ``params`` + ``batch_stats`` as the compressed flax npz of
    ``ssp/train/checkpoint.py::save_weights_npz``, float leaves as fp16 (its
    default: more mantissa than the bf16 the fast forward runs at)."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    flat = {k: v.astype(np.float16) for k, v in state_dict_to_flax(sd).items()}
    path = Path(path)
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)
    return path


def load_reference_state_dict(model: nn.Module, state_dict: Mapping[str, Any]) -> nn.Module:
    """Strict load of a reference-layout state dict (tensors or arrays).
    BN ``num_batches_tracked`` counters, which the JAX exporter does not
    write, default to 0 as in any unversioned state dict."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    return model


def _read_flax(path_or_dict: Union[str, Path, Mapping[str, Any]],
               model_name: str) -> Dict[str, Any]:
    """Flat flax keys of an npz file (or its dict) for ``model_name``: a
    semantic checkpoint read as ``SuperPointNet_gauss2`` loses its
    ``convDS``/``convSout`` scopes, as the JAX factory drops ``n_classes``."""
    if isinstance(path_or_dict, (str, Path)):
        with np.load(Path(path_or_dict)) as data:
            flat = {k: data[k] for k in data.files}
    else:
        flat = _flatten(path_or_dict)
    if model_name == "SuperPointNet_gauss2":
        flat = {k: v for k, v in flat.items() if k.split("/")[1] not in _SEMANTIC_SCOPES}
    return flat


def load_flax_npz(path_or_dict: Union[str, Path, Mapping[str, Any]], model_name: str,
                  *, device="cuda") -> nn.Module:
    """A flax-keyed npz file (or its dict) → the port's model, in eval
    mode on ``device``.  ``n_classes`` comes from the checkpoint's
    ``convSout`` kernel for ``SuperPointNet_gauss2_ssmall``."""
    dev = resolve_device(device)
    flat = _read_flax(path_or_dict, model_name)
    params = {}
    if model_name == "SuperPointNet_gauss2_ssmall" and "params/convSout/kernel" in flat:
        params["n_classes"] = int(np.asarray(flat["params/convSout/kernel"]).shape[-1])
    model = build_model(model_name, device="cpu", **params)
    load_reference_state_dict(model, flax_to_state_dict(flat))
    return model.to(dev).eval()


def load_torch_checkpoint(path: Union[str, Path]) -> Tuple[Dict[str, torch.Tensor], int]:
    """A reference checkpoint file → (state dict, ``n_iter``), as
    ``ssp/models/weights.py::load_torch_checkpoint`` reads it.  Three
    payloads: ``{"model_state_dict", "n_iter", ...}``; the Sener split
    model's ``model_*`` submodule state dicts (``model_enc``, ``model_semi``,
    ``model_desc``, ``model_sem``; reference ``models/senner_models.py:109-123``),
    whose layer names are the joint model's and are merged into one dict;
    and a bare state dict (``n_iter`` 0).  Only tensors and plain
    containers are unpickled (``weights_only=True``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model_state_dict" in payload:
        return dict(payload["model_state_dict"]), int(payload.get("n_iter", 0))
    if isinstance(payload, dict) and any(
            k.startswith("model_") and isinstance(v, dict) for k, v in payload.items()):
        merged: Dict[str, torch.Tensor] = {}
        for k, sub in payload.items():
            if k.startswith("model_") and isinstance(sub, dict):
                merged.update(sub)
        return merged, int(payload.get("n_iter", 0))
    return dict(payload), 0


def _not_orbax(path: Path) -> None:
    if path.is_dir():
        raise ValueError(f"{path} is a directory (an orbax checkpoint); reading it needs the "
                         f"JAX package: export it with ssp.train.checkpoint.save_weights_npz")


def read_state_dict(path: Union[str, Path], model_name: str) -> Dict[str, torch.Tensor]:
    """The reference-named state dict of a weights file for ``model_name``:
    a flax ``.npz`` or a reference checkpoint file (``.pth.tar``, or a bare
    state dict as ``superpoint_v1.pth``).  An orbax directory raises."""
    path = Path(path)
    _not_orbax(path)
    if path.suffix == ".npz":
        return flax_to_state_dict(_read_flax(path, model_name))
    return load_torch_checkpoint(path)[0]


def load_weights(path: Union[str, Path], model_name: str,
                 params: Optional[Mapping[str, Any]] = None, *,
                 device="cuda") -> nn.Module:
    """The model ``model_name`` (built with ``params``) with the weights at
    ``path``, in eval mode on ``device``: a ``.npz`` through
    :func:`load_flax_npz`, a reference checkpoint file through
    :func:`load_torch_checkpoint`.  An orbax checkpoint directory raises:
    reading one needs the JAX package."""
    path = Path(path)
    params = dict(params or {})
    _not_orbax(path)
    if path.suffix == ".npz":
        model = load_flax_npz(path, model_name, device=device)
        n_classes = getattr(model, "n_classes", None)
        if getattr(model, "semantic", False) and params.get("n_classes", n_classes) != n_classes:
            raise ValueError(f"{path} has {n_classes} classes, the config "
                             f"{params['n_classes']}")
        return model
    dev = resolve_device(device)
    model = build_model(model_name, device="cpu", **params)
    load_reference_state_dict(model, read_state_dict(path, model_name))
    return model.to(dev).eval()
