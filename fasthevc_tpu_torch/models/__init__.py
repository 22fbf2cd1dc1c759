"""Learned fast-partition model (the FastHEVC delta): a small CNN predicts
the CU partition depth map of each CTU from its pixels, trained by
self-distillation on the encoder's own full-RDO decisions.  Counterpart
of fasthevc_tpu/models/; inference is fused into the searches (K13),
training runs K13-K15 (`ops/cnn.py`).
"""

from .partition_cnn import (
    PartitionCNN,
    init_params,
    load_params,
    params_from_flax,
    params_to_flax,
    predict_depth_maps,
    predict_depth_maps_device,
    save_params,
    train_self_distilled,
)

__all__ = ["PartitionCNN", "init_params", "load_params", "params_from_flax",
           "params_to_flax", "predict_depth_maps",
           "predict_depth_maps_device", "save_params",
           "train_self_distilled"]
