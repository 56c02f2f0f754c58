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
* :func:`load_weights` loads what a config's ``pretrained`` names: a flax
  npz or a reference checkpoint (an orbax directory needs the JAX package).

Layout: flax conv kernels are HWIO, torch's OIHW; flax BN ``scale``/
``bias``/``mean``/``var`` are torch BN ``weight``/``bias``/
``running_mean``/``running_var``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ssp_torch._device import resolve_device
from ssp_torch.models.superpoint import SuperPointGauss2, build_model

# flax scope → reference prefix of the DoubleConv's Sequential
_BLOCKS = {
    "inc": "inc.conv.conv",
    "down1": "down1.mpconv.1.conv",
    "down2": "down2.mpconv.1.conv",
    "down3": "down3.mpconv.1.conv",
}
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
    if scope in _BLOCKS:
        cbr, layer, leaf = rest
        i = int(cbr.rsplit("_", 1)[1])
        idx = 3 * i + (0 if layer == "Conv_0" else 1)
        prefix = f"{_BLOCKS[scope]}.{idx}"
    elif scope in _HEADS:
        layer, leaf = rest
        prefix = _HEADS[scope][0 if layer == "Conv_0" else 1]
    elif scope == "convSout":
        (leaf,) = rest
        prefix = "convSout"
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
    ``{"params", "batch_stats"}`` tree — → reference-named fp32 tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(variables).items():
        arr = np.asarray(value, dtype=np.float32)
        if key.endswith("/kernel"):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        sd[_flax_to_torch_name(key)] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_reference_state_dict(model: SuperPointGauss2,
                              state_dict: Mapping[str, Any]) -> SuperPointGauss2:
    """Strict load of a reference-layout state dict (tensors or arrays).
    BN ``num_batches_tracked`` counters, which the JAX exporter does not
    write, default to 0 as in any unversioned state dict."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    return model


def load_flax_npz(path_or_dict: Union[str, Path, Mapping[str, Any]], model_name: str,
                  *, device="cuda") -> SuperPointGauss2:
    """A flax-keyed npz file (or its dict) → the port's model, in eval
    mode on ``device``.  ``n_classes`` comes from the checkpoint's
    ``convSout`` kernel for ``SuperPointNet_gauss2_ssmall``."""
    dev = resolve_device(device)
    if isinstance(path_or_dict, (str, Path)):
        with np.load(Path(path_or_dict)) as data:
            flat = {k: data[k] for k in data.files}
    else:
        flat = _flatten(path_or_dict)
    params = {}
    if model_name == "SuperPointNet_gauss2":
        flat = {k: v for k, v in flat.items() if k.split("/")[1] not in _SEMANTIC_SCOPES}
    elif "params/convSout/kernel" in flat:
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


def load_weights(path: Union[str, Path], model_name: str,
                 params: Optional[Mapping[str, Any]] = None, *,
                 device="cuda") -> SuperPointGauss2:
    """The model ``model_name`` (built with ``params``) with the weights at
    ``path``, in eval mode on ``device``: a ``.npz`` through
    :func:`load_flax_npz`, a reference checkpoint file through
    :func:`load_torch_checkpoint`.  An orbax checkpoint directory raises:
    reading one needs the JAX package."""
    path = Path(path)
    params = dict(params or {})
    if path.is_dir():
        raise ValueError(f"{path} is a directory (an orbax checkpoint); reading it needs the "
                         f"JAX package: export it with ssp.train.checkpoint.save_weights_npz")
    if path.suffix == ".npz":
        model = load_flax_npz(path, model_name, device=device)
        if model.semantic and params.get("n_classes", model.n_classes) != model.n_classes:
            raise ValueError(f"{path} has {model.n_classes} classes, the config "
                             f"{params['n_classes']}")
        return model
    dev = resolve_device(device)
    state_dict, _ = load_torch_checkpoint(path)
    model = build_model(model_name, device="cpu", **params)
    load_reference_state_dict(model, state_dict)
    return model.to(dev).eval()
