from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2, flax_params, params_from_flax

__all__ = ["VTCNN2", "flax_params", "params_from_flax"]
