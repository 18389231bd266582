"""Serving export of the port (counterpart of stlpose_tpu/serving):
``torch.export`` artifacts that load and serve without model code."""

from stlpose_tpu_torch.serving.export import (export_detector_server,
                                              export_pose_server,
                                              export_two_stage_server,
                                              load_pose_server,
                                              load_two_stage_server)

__all__ = ["export_detector_server", "export_pose_server",
           "export_two_stage_server", "load_pose_server",
           "load_two_stage_server"]
