"""Dataset factory (port of `open3dsot_tpu/data/__init__.py`).

Only the synthetic dataset with the eval (`test`) sampler is ported so far;
every other dataset or sampler type raises NotImplementedError.
"""

from __future__ import annotations

_TODO = "not ported yet: see ROADMAP.md, modules to port"


def get_dataset(config, type: str = "test", split: str = "test", **kwargs):
    name = getattr(config, "dataset", "kitti").lower()
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name!r} is {_TODO}")
    if type.lower() != "test":
        raise NotImplementedError(f"dataset type {type!r} (training) is {_TODO}")
    from open3dsot_tpu_torch.data.sampler import TestTrackingSampler
    from open3dsot_tpu_torch.data.synthetic import SyntheticDataset

    data = SyntheticDataset(
        split=split,
        num_tracklets=getattr(config, "syn_num_tracklets", 4),
        tracklet_len=getattr(config, "syn_tracklet_len", 8),
        seed=getattr(config, "seed", 42),
        up_axis=getattr(config, "up_axis", (0, 0, 1)),
    )
    return TestTrackingSampler(dataset=data, config=config)
