"""Tracklet evaluation driver, port of `open3dsot_tpu/tracking/eval.py`.

Frame 0 is the ground truth; each later frame builds its model input on the
host around the previous prediction, runs one forward on the model's
device, fetches the 4-DoF box to the host, converts it to a world box and
scores overlap/accuracy against the ground truth (reference
base_model.py:59-117). `results_writer` writes each tracklet's trajectory
(tracking/results.py). `shard_across_processes` spreads the tracklets over
the ranks of a process group (parallel/distributed.py) and sums their
metric states, as the JAX package's (tracking/eval.py).
Under bf16 compute (`bf16: true`) the forward's boxes still come back f32
(the models cast their heads back, as JAX's do), so the host's box math and
Success/Precision are computed as in f32.
"""

from __future__ import annotations

from typing import Optional

from open3dsot_tpu_torch.geometry.iou import estimateAccuracy, estimateOverlap
from open3dsot_tpu_torch.parallel import distributed
from open3dsot_tpu_torch.utils.metrics import Precision, Success


class Tracker:
    """Runs a model wrapper's eval forward frame by frame."""

    def __init__(self, model):
        self.model = model

    def forward(self, data_dict: dict) -> dict:
        return self.model.apply(data_dict)

    def evaluate_one_sequence(self, sequence, config):
        ious, distances, results_bbs = [], [], []
        for frame_id in range(len(sequence)):
            this_bb = sequence[frame_id]["3d_bbox"]
            if frame_id == 0:
                results_bbs.append(this_bb)
            else:
                data_dict, ref_bb = self.model.build_input_dict(sequence, frame_id, results_bbs)
                output = self.forward(data_dict)
                candidate_box = self.model.extract_output_box(output, ref_bb)
                results_bbs.append(candidate_box)
            ious.append(
                estimateOverlap(this_bb, results_bbs[-1], dim=config.IoU_space,
                                up_axis=config.up_axis)
            )
            distances.append(
                estimateAccuracy(this_bb, results_bbs[-1], dim=config.IoU_space,
                                 up_axis=config.up_axis)
            )
        return ious, distances, results_bbs


def tracklet_stripe(n: int, shard_across_processes: bool) -> range:
    """The tracklets of this rank: r, r + world, ... below n when sharded
    (the JAX package's stride over processes), else all."""
    if shard_across_processes:
        return range(distributed.rank(), n, distributed.world_size())
    return range(n)


def merge_process_metrics(success, precision, shard_across_processes: bool, device="cpu") -> None:
    """Sum the fixed-size metric states over the ranks (one all_reduce of a
    few dozen floats, whatever the dataset's size)."""
    if not shard_across_processes or distributed.world_size() == 1:
        return
    import numpy as np
    import torch

    states = [m.state() for m in (success, precision)]
    flat = torch.from_numpy(np.concatenate(states).astype(np.float64)).to(device)
    summed = distributed.all_reduce_sum(flat).cpu().numpy()
    success.load_state(summed[:len(states[0])])
    precision.load_state(summed[len(states[0]):])


def evaluate_dataset(model, test_sampler, config, max_tracklets: Optional[int] = None,
                     verbose: bool = False, shard_across_processes: bool = False,
                     results_writer=None):
    """Run the tracker over every tracklet; returns (success, precision).

    shard_across_processes: each rank of the process group takes tracklets
    rank, rank + world, ..., and the metric states are summed over the
    ranks at the end, so every rank returns the whole dataset's scores.

    results_writer: optional tracking.results.ResultsWriter, which persists
    each tracklet's predicted trajectory and per-frame scores (a rank's own
    tracklets, under their dataset indices).
    """
    tracker = Tracker(model)
    success, precision = Success(), Precision()
    n = len(test_sampler)
    if max_tracklets is not None:
        n = min(n, max_tracklets)
    for i in tracklet_stripe(n, shard_across_processes):
        sequence = test_sampler[i]
        ious, distances, result_bbs = tracker.evaluate_one_sequence(sequence, config)
        if results_writer is not None:
            results_writer.add(i, result_bbs, ious, distances)
        success.update(ious)
        precision.update(distances)
        if verbose:
            print(f"tracklet {i + 1}/{n} len={len(sequence)} "
                  f"success={success.compute():.2f} precision={precision.compute():.2f}")
    merge_process_metrics(success, precision, shard_across_processes, model.device)
    return success.compute(), precision.compute()
