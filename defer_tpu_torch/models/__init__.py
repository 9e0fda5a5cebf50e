"""Model zoo covering the five BASELINE.md benchmark configs (ResNet50/8,
VGG19/4, InceptionV3/6, MobileNetV2/2, BERT-Base/12), GPT and the MoE
families; each family has a ``*_tiny`` variant for fast CPU tests."""

from .bert import BERT_BASE_12STAGE_CUTS, bert, bert_base, bert_tiny
from .gpt import gpt, gpt2_small, gpt_small, gpt_stage_cuts, gpt_tiny
from .inception import (INCEPTION_6STAGE_CUTS, inception, inception_tiny,
                        inception_v3)
from .mobilenet import MOBILENETV2_2STAGE_CUTS, mobilenet_tiny, mobilenet_v2
from .moe import (moe_branched, moe_branched_tiny, moe_stage_cuts,
                  moe_tiny, moe_transformer)
from .resnet import RESNET50_8STAGE_CUTS, resnet, resnet50, resnet_tiny
from .vgg import VGG19_4STAGE_CUTS, vgg, vgg19, vgg_tiny

__all__ = [
    "resnet", "resnet50", "resnet_tiny", "RESNET50_8STAGE_CUTS",
    "vgg", "vgg19", "vgg_tiny", "VGG19_4STAGE_CUTS",
    "inception", "inception_v3", "inception_tiny", "INCEPTION_6STAGE_CUTS",
    "mobilenet_v2", "mobilenet_tiny", "MOBILENETV2_2STAGE_CUTS",
    "bert", "bert_base", "bert_tiny", "BERT_BASE_12STAGE_CUTS",
    "gpt", "gpt2_small", "gpt_small", "gpt_tiny", "gpt_stage_cuts",
    "moe_transformer", "moe_tiny", "moe_stage_cuts",
    "moe_branched", "moe_branched_tiny",
]
