"""Model substrate of the port: configs, layers, attention, MoE, the
Mamba2 and RWKV6 blocks, whisper, and the decoder stacks of every family
(dense, MoE, VLM, hybrid, SSM), and the training loss."""
from .config import INPUT_SHAPES, InputShape, ModelConfig
from .model import (decode_step, forward_train, init_caches, init_params,
                    loss_fn, prefill)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "decode_step",
           "forward_train", "init_caches", "init_params", "loss_fn",
           "prefill"]
