from .resnet import RESNET50_8STAGE_CUTS, resnet, resnet50, resnet_tiny

__all__ = ["RESNET50_8STAGE_CUTS", "resnet", "resnet50", "resnet_tiny"]
