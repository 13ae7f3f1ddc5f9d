"""Dataset factory, port of `open3dsot_tpu/data/__init__.py`.

`get_dataset(config, type, split)` selects the raw dataset by config.dataset
(kitti | nuscenes | waymo | synthetic) and wraps it in a sampler by type:
eval (`test`), siamese training (`train_siamese`, BAT and P2B) or motion
training (`train_motion`, M2-Track).
"""

from __future__ import annotations


def get_dataset(config, type: str = "test", split: str = "test", **kwargs):
    name = getattr(config, "dataset", "kitti").lower()
    if name == "kitti":
        from open3dsot_tpu_torch.data.kitti import KittiDataset

        data = KittiDataset(
            path=config.path,
            split=split,
            category_name=config.category_name,
            coordinate_mode=config.coordinate_mode,
            preload_offset=config.preload_offset if "train" in type.lower() else -1,
            preloading=getattr(config, "preloading", True),
        )
    elif name == "nuscenes":
        from open3dsot_tpu_torch.data.nuscenes_data import NuScenesDataset

        # the reference's rules: training can only use keyframes; the
        # min_points filter applies to the val/test splits only
        is_test = type.lower() == "test"
        eval_splits = [getattr(config, "val_split", None), getattr(config, "test_split", None)]
        data = NuScenesDataset(
            path=config.path,
            split=split,
            category_name=config.category_name,
            version=getattr(config, "version", "v1.0-trainval"),
            key_frame_only=getattr(config, "key_frame_only", False) if is_test else True,
            min_points=1 if split in eval_splits else -1,
            preload_offset=-1 if is_test else config.preload_offset,
            preloading=getattr(config, "preloading", True),
        )
    elif name == "waymo":
        from open3dsot_tpu_torch.data.waymo_data import WaymoDataset

        data = WaymoDataset(
            path=config.path,
            split=split,
            category_name=config.category_name,
            preload_offset=config.preload_offset,
            preloading=getattr(config, "preloading", True),
            tiny=getattr(config, "tiny", False),
        )
    elif name == "synthetic":
        from open3dsot_tpu_torch.data.synthetic import SyntheticDataset

        data = SyntheticDataset(
            split=split,
            num_tracklets=getattr(config, "syn_num_tracklets", 4),
            tracklet_len=getattr(config, "syn_tracklet_len", 8),
            seed=getattr(config, "seed", 42),
            up_axis=getattr(config, "up_axis", (0, 0, 1)),
        )
    else:
        raise ValueError(f"unknown dataset {name!r}")

    type_l = type.lower()
    if type_l == "train_siamese":
        from open3dsot_tpu_torch.data.sampler import PointTrackingSampler

        return PointTrackingSampler(
            dataset=data,
            random_sample=getattr(config, "random_sample", False),
            sample_per_epoch=getattr(config, "sample_per_epoch", 10000),
            config=config,
        )
    if type_l == "train_motion":
        from open3dsot_tpu_torch.data.sampler import MotionTrackingSampler

        return MotionTrackingSampler(dataset=data, config=config)
    if type_l == "test":
        from open3dsot_tpu_torch.data.sampler import TestTrackingSampler

        return TestTrackingSampler(dataset=data, config=config)
    raise ValueError(f"unknown dataset type {type!r}")
