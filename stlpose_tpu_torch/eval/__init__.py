"""COCO scoring of the port: the numpy COCOeval and the keypoint
submission file (counterparts of stlpose_tpu/eval)."""
