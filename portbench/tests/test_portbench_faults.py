"""A whole run on the CPU at a toy size, the card's look skipped, with the
timed path broken underneath: `correct` must come out false for each fault
the cell can have (a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced, the exchange
between cards left out), and true unbroken. In the training cell the fault
acts in the window's `fit` alone, after a sound set-up."""

import pytest
import torch

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
SEED = 2**33 + 29
SCAN = {"traffic": {"tracklets": 6, "lengths": [[0, 4], [0.5, 8], [1, 20]], "points": [150, 300],
                    "max_points": 128, "batch": 4}, "config": {"point_sample_size": 64}}
ONLINE = {"traffic": {"tracklets": 8, "lengths": [[0, 3], [0.5, 6], [1, 12]],
                      "points": [100, 200], "slots": 4, "max_points": 128,
                      "first_crop_points": 64, "warmup": 3, "sample": 3},
          "config": {"feature_channel": 32, "hidden_channel": 32, "out_channel": 32,
                     "vote_channel": 32, "template_size": 64, "search_size": 128,
                     "num_proposal": 16}}

TRAIN = {"traffic": {"tracklets": 6, "lengths": [[0, 4], [0.5, 8], [1, 20]], "points": [150, 300],
                     "warmup": 2, "rate_steps": 2},
         "config": {"point_sample_size": 64, "batch_size": 8, "workers": 2}}


def run_cell(name, overrides, devices=None):
    run = harness.Run(name, SEED, 1.0, False, devices=devices or [torch.device("cpu")],
                      overrides=overrides)
    return harness.execute(run, BENCH, 0.0)


def _scan_step_fault(monkeypatch, kind):
    from open3dsot_tpu_torch.tracking import scan_tracker

    make = scan_tracker.make_m2_step

    def broken(*a, **k):
        step = make(*a, **k)

        def f(wlh, ref_box, prev_pts, prev_valid, this_pts, this_valid, step_idx):
            new = step(wlh, ref_box, prev_pts, prev_valid, this_pts, this_valid, step_idx)
            if kind == "unchanged":
                return ref_box.clone()
            if kind == "half":  # the second half of the rows left out
                h = ref_box.shape[0] // 2
                return torch.cat([new[:h], ref_box[h:]]) if h else ref_box.clone()
            bump = torch.zeros_like(new)
            bump[0, 0] = 0.05 * (step_idx.reshape(-1)[0] == 2)
            return new + bump  # one answer altered

        return f

    monkeypatch.setattr(scan_tracker, "make_m2_step", broken)


def test_scan_cell_sound_run_is_correct():
    assert run_cell("m2track_kitti_car.scan_eval_b16", SCAN)["correct"] is True


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_scan_cell_fault_is_not_correct(monkeypatch, kind):
    _scan_step_fault(monkeypatch, kind)
    assert run_cell("m2track_kitti_car.scan_eval_b16", SCAN)["correct"] is False


def test_split_scan_cell_sound_and_without_the_exchange(monkeypatch):
    from open3dsot_tpu_torch.tracking import scan_tracker

    over = dict(SCAN, traffic=dict(SCAN["traffic"], batch=8))
    cpus = [torch.device("cpu")] * 4
    assert run_cell("m2track_kitti_car.scan_eval_x4", over, cpus)["correct"] is True

    def no_exchange(self, host, gt):
        b = host[0].shape[0] // len(self.parts)
        own = self.parts[0]._dispatch([t[:b] for t in host], [t[:b] for t in gt])[0]
        return torch.cat([own] + [torch.zeros_like(own)] * (len(self.parts) - 1))

    monkeypatch.setattr(scan_tracker._ScanTracker, "_track_split", no_exchange)
    assert run_cell("m2track_kitti_car.scan_eval_x4", over, cpus)["correct"] is False


def test_online_cell_sound_run_is_correct():
    assert run_cell("bat_kitti_car.online_32", ONLINE)["correct"] is True


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_online_cell_fault_is_not_correct(monkeypatch, kind):
    from open3dsot_tpu_torch.tracking import online

    make = online.OnlineMatchTracker._make_advance

    def broken(self, model):
        advance = make(self, model)

        def f(*args):
            new = advance(*args)
            ref_old, ref_new = args[0], new[0]
            if kind == "unchanged":
                ref = ref_old.clone()
            elif kind == "half":
                h = ref_old.shape[0] // 2
                ref = torch.cat([ref_new[:h], ref_old[h:]])
            else:
                ref = ref_new.clone()
                ref[1, 1] += 0.05
            return (ref,) + tuple(new[1:])

        return f

    monkeypatch.setattr(online.OnlineMatchTracker, "_make_advance", broken)
    assert run_cell("bat_kitti_car.online_32", ONLINE)["correct"] is False


def test_train_cell_sound_run_is_correct():
    assert run_cell("m2track_kitti_car.train_b100", TRAIN)["correct"] is True


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_train_cell_fault_is_not_correct(monkeypatch, kind):
    from open3dsot_tpu_torch.train import trainer

    step = trainer.train_step
    calls = []

    def broken(model, optimizer, batch, scheduler=None, fetch=False, per_device_stats=False):
        calls.append(None)
        if len(calls) <= TRAIN["traffic"]["warmup"] + TRAIN["traffic"]["rate_steps"]:
            return step(model, optimizer, batch, scheduler, fetch, per_device_stats)  # set-up
        params = list(model.net.parameters())
        if kind == "half":  # the second half of the rows left out
            h = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:h] for k, v in batch.items()}
        before = [p.detach().clone() for p in params]
        out = step(model, optimizer, batch, scheduler, fetch, per_device_stats)
        with torch.no_grad():
            if kind == "unchanged":
                for p, b in zip(params, before):
                    p.copy_(b)
            elif kind == "altered":
                params[0].view(-1)[0] += 0.05
        return out

    monkeypatch.setattr(trainer, "train_step", broken)
    assert run_cell("m2track_kitti_car.train_b100", TRAIN)["correct"] is False
