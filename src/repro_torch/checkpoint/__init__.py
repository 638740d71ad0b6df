"""Parameters carried across from the JAX package (its flat-key
``.npz`` checkpoints or its nested params)."""
from .convert import load_reference_checkpoint, params_from_reference

__all__ = ["load_reference_checkpoint", "params_from_reference"]
