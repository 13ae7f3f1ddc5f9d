"""The Lightning checkpoint bridge (import_torch.py, export_torch.py,
eval_released_ckpt.py, reference_layout.py) against the JAX package's.

State dicts in the reference's Lightning key layout come from torch
replicas of its modules (reference_layout.lightning_template, the layout of
tests/test_import.py and tests/test_import_matching.py) with random values
from a seed. For M2-Track (with and without the second stage), BAT and P2B:
the port's import equals JAX's `import_checkpoint(sd, cfg, model=...)`
through `state_dict_from_jax`, leaf by leaf and bit for bit; the port's
plain forward on those weights equals JAX's within the parity tests' 5e-4;
the port's export equals JAX's on the same variables and template, with
non-zero folded biases; shape mismatches and extra keys raise JAX's
errors. Then `eval_released_ckpt --device cpu` on a tiny KITTI fixture
prints the Success/Precision of JAX's import + evaluate_dataset, and
`main --checkpoint` refuses a Lightning checkpoint, naming that entry point.
"""

from __future__ import annotations

import contextlib
import io
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from open3dsot_tpu.config import load_config as j_load_config
from open3dsot_tpu.export_torch import export_checkpoint as j_export
from open3dsot_tpu.import_torch import import_checkpoint as j_import
from open3dsot_tpu.models import get_model as j_get_model
from open3dsot_tpu_torch import eval_released_ckpt
from open3dsot_tpu_torch.config import load_config as p_load_config
from open3dsot_tpu_torch.export_torch import export_checkpoint as p_export
from open3dsot_tpu_torch.export_torch import save_checkpoint
from open3dsot_tpu_torch.import_torch import import_checkpoint as p_import
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.reference_layout import lightning_template, without_suppressed_biases
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax, variables_of
from tests._torch_port import to_numpy
from tests.test_kitti_e2e import write_kitti_scene

ATOL = 5e-4  # tests/test_torch_m2track.py and test_torch_matching.py
CASES = {
    "m2": ("cfgs/M2_track_kitti.yaml", dict(point_sample_size=32)),
    "m2_one_stage": ("cfgs/M2_track_kitti.yaml",
                     dict(point_sample_size=32, use_second_stage=False)),
    "bat": ("cfgs/BAT_synthetic.yaml", {}),
    "p2b": ("cfgs/P2B_synthetic.yaml", {}),
}


def shapes_of(jm):
    """The JAX model for `import_checkpoint(..., model=)`, its init traced
    for shapes (jax.eval_shape) and filled with zeros: the merge checks the
    structure and shapes against it and takes every leaf from the
    checkpoint, which these tests give whole (every key compared below).
    The eager flax init takes 15-26 s a model on a CPU."""
    def init(key, batch):
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      jax.eval_shape(jm.init, key, batch))

    return SimpleNamespace(init=init, dummy_batch=jm.dummy_batch)


def _setup(case: str, seed: int = 0):
    path, over = CASES[case]
    over = dict(over, dataset="synthetic")
    pcfg, jcfg = p_load_config(path, over), j_load_config(path, over)
    port = get_model(pcfg.net_model)(pcfg, device="cpu", fused_eval=False)
    jm = j_get_model(jcfg.net_model)(jcfg)
    return pcfg, jcfg, port, jm


def lightning_sd(cfg, net, seed: int) -> dict:
    """A random Lightning-keyed state dict (numpy) at the widths of `net`:
    the replicas' layout, every value drawn from `seed` (running variances
    positive), so that no BatchNorm is the identity."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in lightning_template(cfg, variables_of(net)).items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3
        sd[k] = np.abs(x) + 0.5 if k.endswith("running_var") else x
    return sd


def _batch(case: str, cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if case.startswith("m2"):
        n = 2 * cfg.point_sample_size
        return {"points": rng.standard_normal((2, n, 5)).astype(np.float32),
                "candidate_bc": np.abs(rng.standard_normal((2, n, 9))).astype(np.float32)}
    batch = {"template_points": rng.standard_normal((2, cfg.template_size, 3)).astype(np.float32),
             "search_points": rng.standard_normal((2, cfg.search_size, 3)).astype(np.float32)}
    if case == "bat":
        batch["points2cc_dist_t"] = np.abs(
            rng.standard_normal((2, cfg.template_size, 9))).astype(np.float32)
    return batch


@pytest.mark.parametrize("case", list(CASES))
def test_import_equals_jax_and_forwards_agree(case):
    pcfg, jcfg, port, jm = _setup(case)
    sd = lightning_sd(pcfg, port.net, seed=1)
    got = state_dict_from_jax(p_import(sd, pcfg, model=port))
    variables = to_numpy(j_import(sd, jcfg, model=shapes_of(jm)))
    want = state_dict_from_jax(variables)
    assert set(got) == set(want) == set(port.net.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    port.net.load_state_dict(got, strict=True)
    batch = _batch(case, pcfg, seed=2)
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)
    out = port.apply(batch)
    assert set(out) == set(ref)
    for k in ref:
        if k == "sample_idxs":
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
        else:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k], np.float32),
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_export_equals_jax_and_round_trips(case):
    """Non-zero Dense biases that torch suppresses are folded into the BN
    mean in float64, as JAX folds them; with those biases at zero the
    checkpoint imports back to the same tree bit for bit."""
    pcfg, jcfg, port, _ = _setup(case)
    variables = random_variables(port.net, seed=3)
    template = {k: v.numpy() for k, v in lightning_template(pcfg, variables, seed=4).items()}
    got, want = p_export(variables, pcfg, template), j_export(variables, jcfg, template)
    assert list(got) == list(want) == list(template)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    zeroed = without_suppressed_biases(variables, pcfg, template)
    a, b = state_dict_from_jax(variables), state_dict_from_jax(zeroed)
    changed = [k for k in a if not torch.equal(a[k], b[k])]
    assert all(k.endswith("dense.bias") and not b[k].any() for k in changed)
    assert len(changed) == {"bat": 24, "p2b": 22}.get(case, 0)  # the convs under a BN
    back = p_import(p_export(zeroed, pcfg, template), pcfg, model=port)
    a, b = state_dict_from_jax(back), state_dict_from_jax(zeroed)
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_shape_mismatch_and_extra_keys_raise_as_jax():
    pcfg, jcfg, port, jm = _setup("m2_one_stage")
    sd = lightning_sd(pcfg, port.net, seed=5)
    bad = dict(sd)
    bad["motion_mlp.0.weight"] = bad["motion_mlp.0.weight"][:-1]
    errors = []
    for fn, cfg, model in ((p_import, pcfg, port), (j_import, jcfg, shapes_of(jm))):
        with pytest.raises(ValueError, match="shape mismatch at params/motion_mlp") as e:
            fn(bad, cfg, model=model)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    # a two-stage checkpoint into a one-stage model: keys the model lacks
    p2, j2 = _setup("m2")[:2]
    full = lightning_sd(p2, _setup("m2")[2].net, seed=6)
    errors = []
    for fn, cfg, model in ((p_import, p2, port), (j_import, j2, shapes_of(jm))):
        with pytest.raises(ValueError, match="imported keys not in model") as e:
            fn(full, cfg, model=model)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.fixture(scope="module")
def kitti_test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_test")
    for k, scene in enumerate(("0019", "0020")):  # the test split
        write_kitti_scene(str(root), scene=scene, n_frames=5, seed=k)
    return str(root)


def test_eval_released_ckpt_prints_jax_success_precision(kitti_test_split, tmp_path):
    over = dict(point_sample_size=64, category_name="Car", preloading=False)
    cfg_path = tmp_path / "m2_kitti_small.yaml"
    with open("cfgs/M2_track_kitti.yaml") as f:
        cfg_path.write_text(yaml.safe_dump(dict(yaml.safe_load(f), **over)))
    pcfg = p_load_config(str(cfg_path), {"path": kitti_test_split})
    port = get_model("m2track")(pcfg, device="cpu")
    variables = random_variables(port.net, seed=7)
    template = lightning_template(pcfg, variables)
    ckpt = str(tmp_path / "m2.ckpt")
    save_checkpoint(variables, pcfg, template, ckpt)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eval_released_ckpt.main(["--cfg", str(cfg_path), "--ckpt", ckpt, "--data",
                                 kitti_test_split, "--device", "cpu"])
    got = [ln for ln in out.getvalue().splitlines() if ln.startswith("success/test:")]

    from open3dsot_tpu.data import get_dataset as j_get_dataset
    from open3dsot_tpu.tracking.eval import evaluate_dataset as j_evaluate

    jcfg = j_load_config(str(cfg_path), {"path": kitti_test_split})
    jm = j_get_model("m2track")(jcfg)
    jv = j_import(ckpt, jcfg, model=shapes_of(jm))
    succ, prec = j_evaluate(jm, jv, j_get_dataset(jcfg, "test", jcfg.test_split), jcfg)
    assert got == [f"success/test: {succ:.2f}  precision/test: {prec:.2f}"]
    assert 0 < succ <= 100


def test_checkpoint_flag_refuses_a_lightning_ckpt(tmp_path):
    """A Lightning .ckpt has a state_dict and no step: main --checkpoint
    raises and names eval_released_ckpt, before any load_state_dict."""
    from open3dsot_tpu_torch.main import main
    from open3dsot_tpu_torch.train.trainer import state_dict_of_checkpoint

    pcfg = p_load_config("cfgs/M2_track_synthetic.yaml", {"point_sample_size": 32})
    port = get_model("m2track")(pcfg, device="cpu")
    variables = random_variables(port.net, seed=8)
    ckpt = str(tmp_path / "released.ckpt")
    save_checkpoint(variables, pcfg, lightning_template(pcfg, variables), ckpt)
    with pytest.raises(ValueError, match="eval_released_ckpt"):
        main(["--cfg", "cfgs/M2_track_synthetic.yaml", "--test", "--checkpoint", ckpt,
              "--device", "cpu"])
    with pytest.raises(ValueError, match="eval_released_ckpt"):
        state_dict_of_checkpoint({"state_dict": {}, "hyper_parameters": {}})
    sd = port.net.state_dict()
    assert state_dict_of_checkpoint({"state_dict": sd, "step": 3}) is sd
    assert state_dict_of_checkpoint(sd) is sd
