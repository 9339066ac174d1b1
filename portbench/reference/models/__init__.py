from .backbone import CNNEncoder
from .decoder import DecoderOutput, DecoderSplattingCfg, decode_splatting
from .dpt import DPTUpsamplerHead, PromptDPTHead
from .encoder import EncoderDepthSplat, EncoderDepthSplatCfg, knn_view_indices
from .ldm_unet import UNetModel
from .mv_transformer import MultiViewFeatureTransformer
from .promptda import PROMPTDA_MODEL_CONFIGS, PromptDA
from .unimatch import DPT_MODEL_CONFIGS, MultiViewUniMatch
from .vit import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoViT, ViTConfig
from .vit_fpn import ViTFeaturePyramid

__all__ = [
    "CNNEncoder",
    "DPTUpsamplerHead",
    "DPT_MODEL_CONFIGS",
    "DecoderOutput",
    "DecoderSplattingCfg",
    "DinoViT",
    "EncoderDepthSplat",
    "EncoderDepthSplatCfg",
    "INTERMEDIATE_LAYER_IDX",
    "MultiViewFeatureTransformer",
    "MultiViewUniMatch",
    "PROMPTDA_MODEL_CONFIGS",
    "PromptDA",
    "PromptDPTHead",
    "UNetModel",
    "VIT_CONFIGS",
    "ViTConfig",
    "ViTFeaturePyramid",
    "decode_splatting",
    "knn_view_indices",
]
