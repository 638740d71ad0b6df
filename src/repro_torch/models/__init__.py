"""Model substrate of the port: configs, layers, attention and the dense
decoder-only transformer (the other families come in later slices)."""
from .config import INPUT_SHAPES, InputShape, ModelConfig
from .model import (decode_step, forward_train, init_caches, init_params,
                    prefill)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "decode_step",
           "forward_train", "init_caches", "init_params", "prefill"]
