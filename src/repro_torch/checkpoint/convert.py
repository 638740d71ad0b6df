"""Carry the JAX package's model parameters into the port.

The reference keeps a dense, MoE, VLM or RWKV model's layers stacked
(every leaf under ``layers`` has a leading layer axis; an MoE layer's
``moe/router/w`` f32 ``[L, D, E]`` and its experts ``moe/{gate,up,down}``
``[L, E, din, dout]``), whisper's ``enc_layers`` and ``dec_layers`` the
same way, and a hybrid's as a list with one Mamba layer dict at each
``"mamba"`` position, ``None`` at each ``"attn"`` position and the one
``shared_attn`` block beside it.  It saves checkpoints as flat
``"/"``-joined keys (``repro.checkpoint``: ``layers/attn/wq/w``,
``layers/0/ssm/in_proj/w``, ``embed/emb``, ...; a list index is its
number, and a ``None`` has no key).  The port keeps each stack as a list
of per-layer dicts (``None`` at a hybrid's attention positions).
:func:`params_from_reference` takes either form, as numpy arrays,
unstacks every stacked layer axis (each list of the port's params but a
hybrid's ``layers``), and checks every key, shape and dtype against the
port's own parameters for the config.  bf16 arrives from numpy as
``ml_dtypes.bfloat16`` (or as raw 2-byte ``V2`` after a trip through
``.npz``) and is carried bit for bit through ``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .._tree import flatten, map_with_keys
from ..models import init_params
from ..models.config import ModelConfig
from ..models.transformer import _device


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


def stacked_keys(cfg: ModelConfig, params: dict) -> list:
    """The keys of ``params`` whose list of layers the reference stacks
    on a leading axis: every list but a hybrid's ``layers``."""
    if cfg.arch_type == "hybrid":
        return []
    return [k for k, v in params.items() if isinstance(v, list)]


def params_from_reference(tree, cfg: ModelConfig, device=None) -> dict:
    """The port's params for ``cfg`` from the reference's: a nested tree
    of arrays (``repro.models.init_params``'s layout) or its flat
    ``"/"``-joined keys.  Raises on a missing or extra key, or a shape or
    dtype that differs from the port's."""
    flat = {k: np.asarray(v) for k, v in flatten(tree).items()}
    want = init_params(cfg, device="meta")
    dev = _device(device)
    seen = set()

    def take(key, leaf, shape):
        arr = flat.get(key)
        if arr is None:
            raise KeyError(f"reference params lack {key}")
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {arr.shape}, want {shape}")
        seen.add(key)
        return _tensor(arr, leaf, key)

    stacked = stacked_keys(cfg, want)
    out = map_with_keys(
        {k: v for k, v in want.items() if k not in stacked},
        lambda key, leaf: take(key, leaf, tuple(leaf.shape)).to(dev))
    for name in stacked:
        n = len(want[name])
        layer = want[name][0] if n else {}
        full = {sub: take(f"{name}/{sub}", leaf, (n, *leaf.shape))
                for sub, leaf in flatten(layer).items()}
        out[name] = [map_with_keys(
            layer, lambda sub, _: full[sub][i].clone().to(dev))
            for i in range(n)]
    extra = sorted(set(flat) - seen)
    if extra:
        raise KeyError(f"reference params the port does not know: {extra}")
    return out


def load_reference_checkpoint(path, cfg: ModelConfig, device=None) -> dict:
    """Params from a ``.npz`` that ``repro.checkpoint.save_checkpoint``
    wrote."""
    with np.load(path) as data:
        return params_from_reference({k: data[k] for k in data.files}, cfg,
                                     device)
