from .bert import BERT_BASE_12STAGE_CUTS, bert, bert_base, bert_tiny
from .gpt import gpt, gpt2_small, gpt_small, gpt_stage_cuts, gpt_tiny
from .resnet import RESNET50_8STAGE_CUTS, resnet, resnet50, resnet_tiny

__all__ = ["BERT_BASE_12STAGE_CUTS", "RESNET50_8STAGE_CUTS", "bert",
           "bert_base", "bert_tiny", "gpt", "gpt2_small", "gpt_small",
           "gpt_stage_cuts", "gpt_tiny", "resnet", "resnet50",
           "resnet_tiny"]
