"""Model substrate of the port: configs, layers, attention, the Mamba2
and RWKV6 blocks, and the dense, hybrid and SSM decoder stacks (MoE, VLM
and audio come in later slices)."""
from .config import INPUT_SHAPES, InputShape, ModelConfig
from .model import (decode_step, forward_train, init_caches, init_params,
                    prefill)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "decode_step",
           "forward_train", "init_caches", "init_params", "prefill"]
