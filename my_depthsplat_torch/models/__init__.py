from .decoder import DecoderOutput, DecoderSplattingCfg, decode_splatting
from .dpt import PromptDPTHead
from .encoder import EncoderDepthSplat, EncoderDepthSplatCfg
from .promptda import PROMPTDA_MODEL_CONFIGS, PromptDA
from .vit import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoViT, ViTConfig

__all__ = [
    "DecoderOutput",
    "DecoderSplattingCfg",
    "DinoViT",
    "EncoderDepthSplat",
    "EncoderDepthSplatCfg",
    "INTERMEDIATE_LAYER_IDX",
    "PROMPTDA_MODEL_CONFIGS",
    "PromptDA",
    "PromptDPTHead",
    "VIT_CONFIGS",
    "ViTConfig",
    "decode_splatting",
]
