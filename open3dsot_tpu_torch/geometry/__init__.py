from open3dsot_tpu_torch.geometry.quaternion import Quaternion
from open3dsot_tpu_torch.geometry.data_classes import Box, PointCloud

__all__ = ["Quaternion", "Box", "PointCloud"]
