from .bert import BERT_BASE_12STAGE_CUTS, bert, bert_base, bert_tiny
from .resnet import RESNET50_8STAGE_CUTS, resnet, resnet50, resnet_tiny

__all__ = ["BERT_BASE_12STAGE_CUTS", "RESNET50_8STAGE_CUTS", "bert",
           "bert_base", "bert_tiny", "resnet", "resnet50", "resnet_tiny"]
