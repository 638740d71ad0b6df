"""Checkpoints: flat-key ``.npz`` save and restore of nested trees of
tensors (``ckpt``), and the parameters carried across from the JAX
package (``convert``: its flat-key ``.npz`` checkpoints or its nested
params)."""
from .ckpt import latest_step, restore_checkpoint, save_checkpoint
from .convert import load_reference_checkpoint, params_from_reference

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_reference_checkpoint", "params_from_reference"]
