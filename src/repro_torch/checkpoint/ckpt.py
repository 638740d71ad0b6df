"""Checkpointing of nested trees of tensors to ``.npz``; port of
``repro.checkpoint.ckpt``.

A tree (dicts, lists, NamedTuples; ``None`` has no key) is saved as flat
``"/"``-joined keys, the keys the reference's key paths make
(``repro_torch._tree.flatten``): ``layers/0/attn/wq/w``, an optimizer state's
``m/embed/emb``.  A file is written as ``ckpt_%08d.npz.tmp.npz`` and moved
into place with ``os.replace``, so a reader never sees half of one.  bf16
leaves travel bit for bit as ``uint16`` (numpy has no bfloat16; the
reference's files hold them as 2-byte ``V2``, which restores the same
way); a restore checks each leaf's shape against the template and raises
``ValueError`` on a mismatch, and casts to the template's dtype.  A
checkpoint of f32 and integer leaves written by either package restores
in the other.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from .._tree import flatten, map_with_keys


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _leaf(arr: np.ndarray, like, key: str):
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(like.shape)}")
    if not isinstance(like, torch.Tensor):
        return arr.astype(like.dtype)
    dev = "cpu" if like.device.type == "meta" else like.device
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "uiV":
            raise ValueError(f"{key}: dtype {arr.dtype}, want the 2-byte "
                             "bits of bfloat16")
        bits = np.array(arr).view(np.int16)            # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    want = torch.empty((), dtype=like.dtype).numpy().dtype
    return torch.from_numpy(np.array(arr.astype(want))).to(dev)


def save_checkpoint(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"  # ends in .npz so np.savez won't rename it
    np.savez(tmp, **{k: _array(v) for k, v in flatten(tree).items()})
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, template):
    """A tree shaped as ``template`` (tensors or numpy arrays at its
    leaves) with each leaf read from the step's file, in the template
    leaf's dtype and on its device."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        return map_with_keys(template,
                             lambda key, like: _leaf(data[key], like, key))
