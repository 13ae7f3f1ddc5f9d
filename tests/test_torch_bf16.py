"""The port's bf16 compute mode of eval (`bf16: true`, `--bf16`,
`M2ScanTracker(compute_dtype=torch.bfloat16)`) against the JAX package's.

As in JAX, parameters and BatchNorm statistics stay f32, and so do geometry
(xyz, FPS, ball query, votes, box composition); the layers compute in bf16
in flax's rounding order (models/layers.py), the kernels K1/K2/K4 in their
bf16 mode (their plain versions here on the CPU; the kernels themselves are
held to those on the card by chip_smoke.py, phase 18).

The kernels' plain versions and the modules that hold a kernel
(SegPointNet, MiniPointNet, SetAbstraction) are held to JAX's bf16 in
tests/test_torch_chain_fused.py and tests/test_torch_sa_fused.py.

Tolerances, each with its reason:
- Whole forwards (M2, BAT, P2B; weights.random_variables, which drive the
  nets far from their trained range): the seg mask (M2) or the proposals'
  objectness sign (BAT/P2B) agree with JAX bf16 on > 97% of points, as
  tests/test_bf16.py requires of bf16 against f32; and over three seeds the
  port's mean distance from the f32 truth, mean |x - truth| / max(|truth|, 1)
  over the boxes (tests/test_sa_fused.py's mean_rel), lies between 0.5x and
  1.5x JAX bf16's + 1e-4 (measured: 0.97x to 1.34x). A bf16 step flipped
  early is amplified by the argmax gates downstream, so the two bf16 paths
  are held to the truth, not to each other. The control: the same net
  switched to f32 sits about 1e-5 from the truth, below the lower limit, so
  a path that quietly computed in f32 would fail. On tests/test_bf16.py's own setup (flax init weights), the
  boxes agree within its atol 0.15 where the masks agree.
- The scan tracker's first step (a rounded copy of the weights, bf16 batch):
  within 5e-2 of JAX's M2ScanTracker(compute_dtype=bf16), against steps of
  order one; whole trajectories are not held (argmax flips compound).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.config import make_config as j_make_config
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu.train.trainer import init_variables
from open3dsot_tpu_torch import main as port_main
from open3dsot_tpu_torch.config import load_config, make_config
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.models.layers import computes_in_bf16, set_compute_dtype
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

BF = torch.bfloat16


# --- whole forwards ---------------------------------------------------------

def _cfg(net, **over):
    return dict(dict(dataset="synthetic", net_model=net, category_name="Car",
                     point_sample_size=32, template_size=64, search_size=128,
                     feature_channel=32, hidden_channel=32, out_channel=32, vote_channel=32,
                     num_proposal=8, k=4, bc_channel=9, box_aware=True, degrees=False,
                     use_z=True, limit_box=False, IoU_space=3, motion_threshold=0.15, seed=0),
                **over)


def _inputs(jm, net, seed):
    rng = np.random.default_rng(seed)
    keys = (["points", "candidate_bc"] if net == "m2track" else
            ["template_points", "search_points"] + (["points2cc_dist_t"] if net == "bat" else []))
    batch = jm.dummy_batch(2)
    out = {}
    for k in keys:
        a = rng.standard_normal(batch[k].shape).astype(np.float32)
        out[k] = np.abs(a) if k in ("candidate_bc", "points2cc_dist_t") else a
    return out


@functools.lru_cache(maxsize=None)
def _jitted(net, bf16, fused):
    """The JAX forward, jitted; M2's bf16 one eager: under jit XLA keeps the
    f32 value between a bf16 op and the next (its excess precision), which
    moves M2's boxes nearer the f32 truth than flax's rounding order, the
    port's, does. The eager flax M2 and the port's agree to the bf16 step."""
    flag = "fused_chain" if net == "m2track" else "fused_sa"
    jm = j_get_model(net)(j_make_config(_cfg(net, bf16=bf16, **{flag: fused})))
    fn = lambda v, b: jm.apply(v, b, train=False)  # noqa: E731
    return jm, fn if (net == "m2track" and bf16) else jax.jit(fn)


def _agreement(net, got, want) -> float:
    if net == "m2track":
        return float((got["seg_logits"].numpy().argmax(-1)
                      == np.asarray(want["seg_logits"]).argmax(-1)).mean())
    return float(((got["estimation_boxes"].numpy()[..., 4] > 0)
                  == (np.asarray(want["estimation_boxes"])[..., 4] > 0)).mean())


def _mean_rel(x, truth) -> float:
    return float(np.mean(np.abs(x - truth) / np.maximum(np.abs(truth), 1.0)))


@pytest.mark.parametrize("fused_eval", [True, False])
@pytest.mark.parametrize("net", ["m2track", "bat", "p2b"])
def test_bf16_forward_against_jax(net, fused_eval, monkeypatch):
    monkeypatch.setenv("OPEN3DSOT_INT8_GATHER", "1")  # JAX's fused SA gathers bf16 rows
    port = get_model(net)(make_config(_cfg(net, bf16=True)), device="cpu", fused_eval=fused_eval)
    assert computes_in_bf16(port.net)
    jm32, f32 = _jitted(net, False, False)
    _, bf = _jitted(net, True, fused_eval)
    dist_port, dist_jax, dist_f32 = [], [], []
    for seed in range(3):
        v = random_variables(port.net, seed)
        port.net.load_state_dict(state_dict_from_jax(v), strict=True)
        batch = _inputs(jm32, net, seed)
        truth = np.asarray(f32(v, batch)["estimation_boxes"])
        want = bf(v, batch)
        got = port.apply(batch)
        assert all(g.dtype == torch.float32 for k, g in got.items() if k != "sample_idxs")
        assert all(torch.isfinite(g).all() for g in got.values())
        assert _agreement(net, got, want) > 0.97
        dist_port.append(_mean_rel(got["estimation_boxes"].numpy(), truth))
        dist_jax.append(_mean_rel(np.asarray(want["estimation_boxes"], np.float32), truth))
        set_compute_dtype(port.net, None)
        dist_f32.append(_mean_rel(port.apply(batch)["estimation_boxes"].numpy(), truth))
        set_compute_dtype(port.net, BF)
    lower, upper = 0.5 * np.mean(dist_jax), 1.5 * np.mean(dist_jax) + 1e-4
    assert lower < np.mean(dist_port) < upper, (dist_port, dist_jax)
    assert np.mean(dist_f32) <= lower, (dist_f32, dist_jax)  # the control
    # parameters and statistics stay f32
    assert all(p.dtype == torch.float32 for p in port.net.parameters())
    assert all(b.dtype == torch.float32 for b in port.net.buffers() if b.is_floating_point())


@pytest.mark.parametrize("net", ["m2track", "bat"])
def test_bf16_forward_on_flax_init_weights(net, monkeypatch):
    """tests/test_bf16.py's setup (flax init weights, normal inputs): the
    port's bf16 boxes against JAX's bf16 at its atol 0.15 where the masks agree.
    These are tests/test_bf16.py's limits of bf16 against f32, which an f32
    path meets too: test_bf16_forward_against_jax is the one that tells the
    modes apart."""
    monkeypatch.setenv("OPEN3DSOT_INT8_GATHER", "1")
    jm, bf = _jitted(net, True, False)
    init = jax.jit(lambda key: init_variables(jm, key, batch_size=2))  # eager init compiles op by op
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    port = get_model(net)(make_config(_cfg(net, bf16=True)), device="cpu")
    port.net.load_state_dict(state_dict_from_jax(v), strict=True)
    batch = _inputs(jm, net, 1)
    want, got = bf(v, batch), port.apply(batch)
    agree = _agreement(net, got, want)
    assert agree > 0.97
    if agree == 1.0:
        np.testing.assert_allclose(got["estimation_boxes"].numpy(),
                                   np.asarray(want["estimation_boxes"], np.float32), atol=0.15)


# --- the scan tracker -------------------------------------------------------

def test_m2_scan_tracker_bf16_first_step_matches_jax():
    from open3dsot_tpu.config import load_config as j_load_config
    from open3dsot_tpu.data import get_dataset as j_get_dataset
    from open3dsot_tpu.tracking import scan_tracker as js
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking import scan_tracker as ps

    cfg_path = "cfgs/M2_track_synthetic.yaml"
    over = dict(point_sample_size=64, syn_num_tracklets=2, syn_tracklet_len=2, seed=5)
    jcfg, pcfg = j_load_config(cfg_path, over), load_config(cfg_path, over)
    port = get_model("m2track")(pcfg, device="cpu")
    v = random_variables(port.net, seed=11)
    port.net.load_state_dict(state_dict_from_jax(v), strict=True)
    jt = js.M2ScanTracker(j_get_model("m2track")(jcfg), v, jcfg, max_points=256, frame_bucket=2,
                          compute_dtype=jnp.bfloat16)
    pt = ps.M2ScanTracker(port, pcfg, max_points=256, frame_bucket=2, compute_dtype=BF)
    want = jt.track_batch([j_get_dataset(jcfg, "test", "test")[i] for i in range(2)])
    got = pt.track_batch([get_dataset(pcfg, "test", "test")[i] for i in range(2)])
    f32 = ps.M2ScanTracker(port, pcfg, max_points=256, frame_bucket=2).track_batch(
        [get_dataset(pcfg, "test", "test")[i] for i in range(2)])
    for g, w, f in zip(got, want, f32):
        assert g.shape == (1, 4) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=5e-2)
        assert not np.array_equal(g, f)  # it did compute in bf16
    # the model's own weights are untouched: the tracker rounds a copy
    assert all(p.dtype == torch.float32 for p in port.net.parameters())
    assert not computes_in_bf16(port.net)


def test_m2_scan_tracker_rounds_again_after_new_weights():
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking import scan_tracker as ps

    pcfg = load_config("cfgs/M2_track_synthetic.yaml",
                       dict(point_sample_size=32, syn_num_tracklets=1, syn_tracklet_len=3))
    port = get_model("m2track")(pcfg, device="cpu")
    port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, seed=1)))
    tr = ps.M2ScanTracker(port, pcfg, max_points=128, frame_bucket=4, compute_dtype=BF)
    seqs = [get_dataset(pcfg, "test", "test")[0]]
    first = tr.track_batch(seqs)[0]
    step = tr._step
    port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, seed=2)))
    second = tr.track_batch(seqs)[0]
    assert tr._step is not step and not np.array_equal(first, second)
    fresh = ps.M2ScanTracker(port, pcfg, max_points=128, frame_bucket=4, compute_dtype=BF)
    np.testing.assert_array_equal(fresh.track_batch(seqs)[0], second)


def test_match_scan_tracker_runs_a_bf16_model():
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking import scan_matching as psm

    over = dict(template_size=64, search_size=128, syn_num_tracklets=2, syn_tracklet_len=3)
    cfg = load_config("cfgs/BAT_synthetic.yaml", dict(over, bf16=True))
    port = get_model("bat")(cfg, device="cpu")
    port.net.load_state_dict(state_dict_from_jax(random_variables(port.net, seed=3)))
    tr = psm.MatchScanTracker(port, cfg, max_points=256, first_crop_points=128, frame_bucket=4)
    seqs = [get_dataset(cfg, "test", "test")[i] for i in range(2)]
    boxes = tr.track_batch(seqs)
    assert all(b.shape == (2, 4) and b.dtype == np.float32 and np.isfinite(b).all()
               for b in boxes)
    # the eager loop is the host loop's forward: its first step equals it
    host = port.apply(port.build_input_dict(seqs[0], 1, [seqs[0][0]["3d_bbox"]])[0])
    assert host["estimation_boxes"].dtype == torch.float32


# --- the CLI and the refusals -----------------------------------------------

@pytest.mark.parametrize("cfg", ["cfgs/M2_track_synthetic.yaml", "cfgs/BAT_synthetic.yaml"])
def test_cli_test_bf16(cfg, capsys):
    port_main.main(["--cfg", cfg, "--test", "--bf16", "--device", "cpu", "--max_tracklets", "1"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("success/test:") and "precision/test:" in last


@pytest.mark.parametrize("name", ["m2track", "bat"])
def test_online_trackers_and_bundles_refuse_bf16(name, tmp_path):
    """Once refused, bf16 serving is taken now: a bf16 model's online tracker
    serves in bf16, a bf16 model swapped into an f32 tracker switches it,
    and a bundle records the mode (tests/test_torch_online_bf16.py holds the
    boxes to the scan trackers' and to JAX's)."""
    import json

    from open3dsot_tpu_torch.tracking import online, serving_export

    path = {"m2track": "cfgs/M2_track_synthetic.yaml", "bat": "cfgs/BAT_synthetic.yaml"}[name]
    cfg = load_config(path, dict(bf16=True))
    model = get_model(name)(cfg, device="cpu")
    assert online.make_online_tracker(model, cfg, max_streams=2,
                                      max_points=64).compute_mode == "bfloat16"
    f32_cfg = load_config(path)
    f32 = get_model(name)(f32_cfg, device="cpu")
    tracker = online.make_online_tracker(f32, f32_cfg, max_streams=2, max_points=64)
    assert tracker.compute_mode == "float32"
    tracker.set_model(model)  # a bf16 model swapped in later
    assert tracker.compute_mode == "bfloat16"
    set_compute_dtype(f32.net, BF)
    tracker.set_model(f32)
    serving_export.save_serving_bundle(tracker, tmp_path / "bundle")
    meta = json.loads((tmp_path / "bundle" / "meta.json").read_text())
    assert meta["compute_mode"] == "bfloat16"
    assert serving_export.load_serving_bundle(tmp_path / "bundle").compute_mode == "bfloat16"


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4"])
def test_operator_fakes_give_the_bf16_mode_dtypes(kernel):
    """torch.export traces the operators through their fakes: in the bf16
    mode K1/K2 still give f32 (the tap, the pool, the logits) and K4 gives
    bf16, as the plain versions do."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from open3dsot_tpu_torch.ops import chain_fused as cf
    from open3dsot_tpu_torch.ops import sa_fused

    g = torch.Generator().manual_seed(0)

    def chain(widths, split=0):
        layers = [(torch.randn(a, b, generator=g) * 0.2, torch.randn(b, generator=g) * 0.1)
                  for a, b in zip(widths[:-1], widths[1:])]
        return cf.FoldedChain(layers, split=split, dtype=BF)

    if kernel == "K1":
        c = chain([5, 16, 8, 24])
        op = torch.ops.open3dsot.fused_pointnet_encoder.default
        args = (torch.randn(2, 40, 5, generator=g), c.packed, c.weights, c.biases,
                c.packed_widths, 1, True)
    elif kernel == "K2":
        c = chain([8 + 24, 16, 3], split=8)
        op = torch.ops.open3dsot.fused_seg_head.default
        args = (torch.randn(2, 40, 8, generator=g), torch.randn(2, 24, generator=g), c.packed,
                c.w_pool, c.weights, c.biases, c.packed_widths, True)
    else:
        layers = [t for w, b in chain([7, 8, 8, 16]).layers for t in (w, b)]
        op = torch.ops.open3dsot.fused_sa_apply.default
        args = (torch.randn(2, 40, 3, generator=g), torch.randn(2, 40, 4, generator=g),
                torch.randn(2, 6, 3, generator=g), layers, [], 0.5, False, True, 8, -1, True)
    plain = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                    [mode.from_tensor(x) for x in a] if isinstance(a, list) and a
                    and isinstance(a[0], torch.Tensor) else a for a in args])
    plain, fake = (o if isinstance(o, tuple) else (o,) for o in (plain, fake))
    assert [(tuple(p.shape), p.dtype) for p in plain] == [(tuple(f.shape), f.dtype) for f in fake]
    assert [p.dtype for p in plain] == ([BF] if kernel == "K4" else [torch.float32] * len(plain))
