from modulationdetectioncnn_torch.models.resnet_rml18 import ResNetRML18
from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2, flax_params, params_from_flax

__all__ = ["ResNetRML18", "VTCNN2", "flax_params", "params_from_flax"]
