"""Dataset factory (port of `open3dsot_tpu/data/__init__.py`).

Only the synthetic dataset is ported so far, with the eval (`test`), the
siamese training (`train_siamese`, BAT and P2B) and the motion training
(`train_motion`, M2-Track) samplers; every other dataset or sampler type
raises NotImplementedError.
"""

from __future__ import annotations

_TODO = "not ported yet: see ROADMAP.md, modules to port"


def get_dataset(config, type: str = "test", split: str = "test", **kwargs):
    name = getattr(config, "dataset", "kitti").lower()
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name!r} is {_TODO}")
    type_l = type.lower()
    if type_l not in ("test", "train_siamese", "train_motion"):
        raise NotImplementedError(f"dataset type {type!r} is {_TODO}")
    from open3dsot_tpu_torch.data.sampler import (
        MotionTrackingSampler,
        PointTrackingSampler,
        TestTrackingSampler,
    )
    from open3dsot_tpu_torch.data.synthetic import SyntheticDataset

    data = SyntheticDataset(
        split=split,
        num_tracklets=getattr(config, "syn_num_tracklets", 4),
        tracklet_len=getattr(config, "syn_tracklet_len", 8),
        seed=getattr(config, "seed", 42),
        up_axis=getattr(config, "up_axis", (0, 0, 1)),
    )
    if type_l == "train_siamese":
        return PointTrackingSampler(
            dataset=data,
            random_sample=getattr(config, "random_sample", False),
            sample_per_epoch=getattr(config, "sample_per_epoch", 10000),
            config=config,
        )
    if type_l == "train_motion":
        return MotionTrackingSampler(dataset=data, config=config)
    return TestTrackingSampler(dataset=data, config=config)
