"""Carry the JAX package's model parameters into the port.

The reference keeps a dense model's layers stacked (every leaf under
``layers`` has a leading layer axis) and saves checkpoints as flat
``"/"``-joined keys (``repro.checkpoint``: ``layers/attn/wq/w``,
``embed/emb``, ...).  The port keeps ``params["layers"]`` as a list of
per-layer dicts.  :func:`params_from_reference` takes either form, as
numpy arrays, unstacks the layer axis, and checks every key, shape and
dtype against the port's own parameters for the config.  bf16 arrives
from numpy as ``ml_dtypes.bfloat16`` (or as raw 2-byte ``V2`` after a
trip through ``.npz``) and is carried bit for bit through ``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import init_params
from ..models.config import ModelConfig
from ..models.transformer import _device


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts -> ``{"a/b/c": leaf}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _tensor(arr: np.ndarray, want: torch.Tensor, key: str) -> torch.Tensor:
    if want.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.name not in ("bfloat16",
                                                            "void16"):
            raise ValueError(f"{key}: dtype {arr.dtype}, want bfloat16")
        bits = np.array(arr).view(np.int16)     # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype.name != str(want.dtype).removeprefix("torch."):
        raise ValueError(f"{key}: dtype {arr.dtype}, want {want.dtype}")
    return torch.from_numpy(np.array(arr))      # a writable copy


def params_from_reference(tree, cfg: ModelConfig, device=None) -> dict:
    """The port's params for ``cfg`` from the reference's: a nested dict
    of arrays (``repro.models.init_params``'s layout) or its flat
    ``"/"``-joined keys.  Raises on a missing or extra key, or a shape or
    dtype that differs from the port's."""
    flat = {k: np.asarray(v) for k, v in flatten(tree).items()}
    want = init_params(cfg, device="meta")
    dev = _device(device)
    n_layers = cfg.n_layers
    out: dict = {}
    seen = set()
    for key, leaf in flatten({k: v for k, v in want.items()
                              if k != "layers"}).items():
        arr = flat.get(key)
        if arr is None:
            raise KeyError(f"reference params lack {key}")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape}, want "
                             f"{tuple(leaf.shape)}")
        _set(out, key, _tensor(arr, leaf, key).to(dev))
        seen.add(key)
    layers = [dict() for _ in range(n_layers)]
    for sub, leaf in flatten(want["layers"][0] if n_layers else {}).items():
        key = f"layers/{sub}"
        arr = flat.get(key)
        if arr is None:
            raise KeyError(f"reference params lack {key}")
        if tuple(arr.shape) != (n_layers, *leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape}, want "
                             f"{(n_layers, *leaf.shape)}")
        t = _tensor(arr, leaf, key)
        for i in range(n_layers):
            _set(layers[i], sub, t[i].clone().to(dev))
        seen.add(key)
    extra = sorted(set(flat) - seen)
    if extra:
        raise KeyError(f"reference params the port does not know: {extra}")
    out["layers"] = layers
    return out


def load_reference_checkpoint(path, cfg: ModelConfig, device=None) -> dict:
    """Params from a ``.npz`` that ``repro.checkpoint.save_checkpoint``
    wrote."""
    with np.load(path) as data:
        return params_from_reference({k: data[k] for k in data.files}, cfg,
                                     device)


def _set(tree: dict, key: str, value) -> None:
    *path, last = key.split("/")
    for p in path:
        tree = tree.setdefault(p, {})
    tree[last] = value
