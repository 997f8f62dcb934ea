from modulationdetectioncnn_torch.data.radioml import load_radioml_pickle
from modulationdetectioncnn_torch.data.synthetic import MODULATIONS, generate_frames, make_dataset

__all__ = ["MODULATIONS", "generate_frames", "load_radioml_pickle", "make_dataset"]
