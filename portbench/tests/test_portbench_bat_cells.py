"""BAT's scan-eval and training cells: the references they are held to
against the port's plain CPU path at toy sizes (the siamese samples, the
training forward's loss and gradients, the first crop), the work counts
against the port's chip check, the five readers on timelines made up here,
and whole toy runs on the CPU, sound and with the timed path broken."""

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, peaks, trace, weights
from portbench.reference import bat as ref_bat
from portbench.reference import bat_train
from portbench.reference import siamese_samples as ss
from portbench.traffic import tracklets
from portbench.work import bat as work_bat
from portbench.work import bat_kernels
from test_portbench_faults import run_cell
from test_portbench_reference import BAT_TOY, _cfg
from test_portbench_trace import Ev

SCAN_CELL, TRAIN_CELL = "bat_kitti_car.scan_eval_b16", "bat_kitti_car.train_b50"
MIX = {"tracklets": 6, "lengths": [[0, 4], [0.5, 8], [1, 20]], "points": [150, 300]}
SCAN = {"traffic": dict(MIX, max_points=300, first_crop_points=128, batch=4), "config": BAT_TOY}
TRAIN = {"traffic": dict(MIX, warmup=2, rate_steps=2),
         "config": dict(BAT_TOY, batch_size=8, workers=2)}
SEED = 2**33 + 41


def _train_setup(B=6):
    """The toy configuration with the device sampler, its weights, tracklets,
    and the port's raw sampler over them."""
    from open3dsot_tpu_torch.data.device_sampler import RawSiameseSampler
    from portbench.traffic.scan_eval import _frames
    from portbench.traffic.train import _Frames

    d, cfg = _cfg("bat_kitti_car", device_sampler=True, **BAT_TOY)
    d["seed"] = 7
    data = tracklets.generate(dict(MIX, object_share=[0.1, 0.3], clutter_half=[6, 6, 1.5]), SEED)
    raw = RawSiameseSampler(_Frames(_frames(data)), cfg)
    rows = ss.loader_rows(len(raw), B, d["seed"], 0, 1)
    return d, cfg, data, raw, rows


def test_siamese_raw_batch_and_build_equal_the_ports():
    from open3dsot_tpu_torch.data.device_sampler import make_siamese_builder

    d, cfg, data, raw, rows = _train_setup()
    want = {k: np.stack([raw[int(i)][k] for i in rows]) for k in raw[0]}
    got = ss.raw_batch(data, rows, int(d["num_candidates"]), 2048)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    t = {k: torch.from_numpy(v) for k, v in got.items()}
    key = ss.step_key(d["seed"], 3)
    port = make_siamese_builder(cfg)(t, key)
    mine = ss.build(d, t, key)
    assert sorted(mine) == sorted(port)
    for k in port:
        torch.testing.assert_close(mine[k], port[k], rtol=0, atol=0, msg=k)


def test_bat_training_loss_and_gradients_equal_the_ports_plain_path():
    """The port's training forward with its plain SA layers (no K6) and its
    loss against the reference's, from the same parameters and batch."""
    from open3dsot_tpu_torch.models import get_model

    d, cfg, data, raw, rows = _train_setup()
    sd = weights.make(ref_bat.param_specs(d), SEED, "cpu")
    model = get_model("bat")(cfg, device="cpu", fused_train=False)
    model.net.load_state_dict(sd)
    batch = ss.build(d, {k: torch.from_numpy(v) for k, v in
                         ss.raw_batch(data, rows, int(d["num_candidates"]), 2048).items()},
                     ss.step_key(d["seed"], 0))
    loss = model.loss(batch, model.apply_train(batch))["loss_total"]
    loss.backward()
    p = {n: sd[n].clone().requires_grad_() for n in bat_train.leaves(sd)}
    want = bat_train.loss(d, batch, bat_train.train_forward(
        p, d, batch["template_points"], batch["search_points"], batch["points2cc_dist_t"]))
    want.backward()
    torch.testing.assert_close(want, loss, rtol=1e-6, atol=0)
    grads = dict(model.net.named_parameters())
    assert sorted(p) == sorted(grads)
    for n, t in p.items():
        torch.testing.assert_close(t.grad, grads[n].grad, rtol=1e-5, atol=1e-7, msg=n)


def test_first_crop_equals_the_scan_trackers():
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.tracking.scan_matching import MatchScanTracker
    from portbench.traffic.scan_eval import _frames

    d, cfg = _cfg("bat_kitti_car", **BAT_TOY)
    model = get_model("bat")(cfg, device="cpu")
    data = tracklets.generate(dict(MIX, object_share=[0.1, 0.3], clutter_half=[6, 6, 1.5]), SEED)
    tracker = MatchScanTracker(model, cfg, max_points=300, first_crop_points=96)
    pts, count = tracker._extra_inputs([s[:1] for s in _frames(data)])
    for b, tr in enumerate(data):
        got, n = ref_bat.first_crop(tr["points"][0], tr["center"][0], float(tr["theta"][0]),
                                    tr["wlh"], d, 96)
        assert n == count[b]
        np.testing.assert_allclose(got, pts[b], atol=1e-6)


def test_work_counts_equal_the_chip_checks_at_its_shapes():
    import chip_smoke

    d, _ = _cfg("bat_kitti_car")
    calls = bat_kernels.k6_calls(d, 50)
    assert 1e3 * sum(peaks.tc_bound_s(*f) for f, _ in calls) == pytest.approx(0.8770, abs=5e-5)
    assert 1e3 * sum(peaks.tc_bound_s(*b) for _, b in calls) == pytest.approx(1.7493, abs=5e-5)
    assert 1e3 * peaks.bound_s(*bat_kernels.k3_work(1, 1024, 512)) == pytest.approx(7e-5,
                                                                                  abs=5e-7)
    for shape in [(50, 256, 128, 32, 128, 128, 256), (50, 128, 64, 32, 256, 256, 256),
                  (16, 512, 256, 32, 128, 128, 256), (1, 256, 128, 32, 256, 256, 256)]:
        assert bat_kernels.k6_work(*shape) == chip_smoke.k6_work(*shape)
    for shape in [(1, 1024, 512), (16, 512, 256), (50, 1024, 512)]:
        assert bat_kernels.k3_work(*shape) == chip_smoke.k3_work(*shape)
    assert bat_kernels.k3_calls(d, 16) == [chip_smoke.k3_work(16, 512, 256),
                                           chip_smoke.k3_work(16, 1024, 512)]


# --- the readers, on timelines made up here ---
def _run(kernels, **counters):
    """A 100 ms window holding `kernels` [(name, ns), ...] back to back."""
    evs, t = [Ev(trace.WINDOW, 0, 100_000_000, kind="user_annotation", device="CPU")], 0
    for name, ns in kernels:
        evs.append(Ev(name, t, ns))
        t += ns
    d, _ = _cfg("bat_kitti_car")
    return SimpleNamespace(counters=dict(counters, timeline=trace.Timeline(evs)), cfg=d,
                           devices=[torch.device("cpu")])


LOOPS = [(16, 9), (4, 2)]  # (B, T) of two frame loops: 8 + 1 replays


def _scan_bound(calls_of, bound_of):
    d, _ = _cfg("bat_kitti_car")
    return sum((T - 1) * sum(bound_of(*c) for c in calls_of(d, B)) for B, T in LOOPS)


def _d():
    return _cfg("bat_kitti_car")[0]


@pytest.mark.parametrize("metric, kernels, counters, want", [
    ("k4_scan_roofline", [("void sa_tc_kernel<1>(SAArgs)", 9_000_000), ("bq_kernel", 1_000_000),
                          ("fps_kernel<4, 256, 1>", 1_000_000)], {"loops": LOOPS},
     lambda: 100 * _scan_bound(work_bat.sa_calls, peaks.tc_bound_s) / 10e-3),
    ("k3_scan_roofline", [("fps_kernel<4, 256, 1>", 600_000), ("fps_kernel<1, 1024, 1>", 400_000),
                          ("bq_kernel", 1_000_000)], {"loops": LOOPS},
     lambda: 100 * _scan_bound(bat_kernels.k3_calls, peaks.bound_s) / 1e-3),
    ("scan.mfu.bat", [("k", 50_000_000)], {"frames": 500},
     lambda: 100 * 500 * work_bat.forward_flops(_d()) / (0.1 * peaks.F32_ACCURATE_FLOPS)),
    ("k6_roofline", [("void (anonymous namespace)::rowmm_kernel<0, 1, false>(RowArgs)", 12_000_000),
                     ("dw_kernel<2, 1, false>", 6_000_000), ("scatter_kernel<false>", 2_000_000),
                     ("at::native::_scatter_gather_elementwise_kernel", 5_000_000),
                     ("sa_tc_kernel<1>", 1_000_000)], {"steps": 2},
     lambda: 100 * 2 * sum(peaks.tc_bound_s(*f) + peaks.tc_bound_s(*b)
                           for f, b in bat_kernels.k6_calls(_d(), 50)) / 20e-3),
    ("train.mfu.bat", [("k", 50_000_000)], {"rows": 100},
     lambda: 100 * 100 * 3 * work_bat.forward_flops(_d()) / (0.1 * peaks.F32_ACCURATE_FLOPS)),
])
def test_reader_on_a_made_up_timeline(metric, kernels, counters, want):
    value = harness.reader(metric).read(_run(kernels, **counters))
    assert value == pytest.approx(want(), rel=1e-12)
    assert 0 < value < 100


@pytest.mark.parametrize("metric, counters, own", [
    ("k4_scan_roofline", {"loops": LOOPS}, "sa_tc_kernel"),
    ("k3_scan_roofline", {"loops": LOOPS}, "fps_kernel"),
    ("k6_roofline", {"steps": 2}, "rowmm_kernel"),
    ("scan.mfu.bat", {"frames": 10}, None), ("train.mfu.bat", {"rows": 10}, None)])
def test_reader_finds_nothing_to_read(metric, counters, own):
    """No device record in the window, none of its kernels, or no count of
    the work: None."""
    read = harness.reader(metric).read
    assert read(_run([], **counters)) is None
    if own:
        assert read(_run([("other_kernel", 1000)], **counters)) is None
    assert read(_run([(own or "k", 1000)])) is None


# --- whole toy runs on the CPU ---
def test_scan_cell_sound_run_is_correct():
    line = run_cell(SCAN_CELL, SCAN)
    assert line["correct"] is True and line["attempted"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_scan_cell_fault_is_not_correct(monkeypatch, kind):
    from open3dsot_tpu_torch.tracking import scan_matching

    make = scan_matching.make_match_step
    calls = []

    def broken(*a, **k):
        step = make(*a, **k)

        def f(first_pts, first_valid, carry, xs):
            new, box = step(first_pts, first_valid, carry, xs)
            calls.append(None)
            if kind == "unchanged":
                box = carry[0].clone()
            elif kind == "half":  # the second half of the rows left out
                h = box.shape[0] // 2
                box = torch.cat([box[:h], carry[0][h:]])
            elif len(calls) % 5 == 2:  # one answer in five steps altered
                box = box.clone()
                box[0, 0] += 0.05
            return (box,) + tuple(new[1:]), box

        return f

    monkeypatch.setattr(scan_matching, "make_match_step", broken)
    assert run_cell(SCAN_CELL, SCAN)["correct"] is False


def test_train_cell_sound_run_is_correct():
    assert run_cell(TRAIN_CELL, TRAIN)["correct"] is True


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
    assert run_cell(TRAIN_CELL, TRAIN)["correct"] is False


def test_new_runners_and_references_load_no_jax_and_references_no_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.siamese_samples, portbench.reference.bat_train\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'open3dsot_tpu_torch']\n"
            "import portbench.traffic.scan_match_eval, portbench.traffic.train_siamese\n"
            "import portbench.work.bat_kernels\n"
            "from portbench.harness import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()\n" % str(harness.ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.card
def test_half_batch_fault_fails_the_bat_training_cell(card):
    from portbench import calibrate

    reading = calibrate.readings(TRAIN_CELL, 2**31 + 79, 1.0, True, [card], fault="half")
    limits = harness.load_json(harness.HERE / "workloads" / f"{TRAIN_CELL}.json")["limits"]
    assert any(v > limits[n] for n, v in reading["checks"].items()), reading
