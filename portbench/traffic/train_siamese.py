"""Traffic runner `train_siamese`: the port's `Trainer.fit` on a matching
model (BAT here, `train_type: train_siamese`) with its samples built on the
card.

Set-up, window and release are the `train` runner's (portbench/traffic/
train.py): weights and tracklets from the seed (the seed also the
configuration's `seed`), one `Trainer`, a `fit` of `warmup` steps, one of
`rate_steps` whose rate sizes the window, then the window's `fit`;
`train_samples_per_s` is its rows over its wall time. The mix's
`device_sampler` is set in the configuration the port gets, so that the
configuration's file stays as published.

The check holds the window's own first three steps to the plain reference
(portbench/reference/bat_train.py for BAT's training forward and loss,
siamese_samples.py for the samples), from the parameters the window starts
from, as the `train` runner does: the first step's loss, the first
gradient as Adam got it and every parameter's change over the three
steps, the last two by the worst leaf's gap of norms against the larger of
that leaf's reference norm and the median leaf's. The port's SA layers 2-3
run K6 in 3xTF32, whose rounding differs from the reference's float32:
the maxima and ReLU masks of near ties fall otherwise, and Adam's
normalised steps carry that into the later steps, so the losses of steps
2-3 and the median leaf's change are recorded (`loss_gap_steps`,
`median_change_gap`) and not compared (PERF.md). The control (`control`)
is the reference in the program's place from the state the reference
reaches through the set-up's two fits: in TF32, or, with `fault="half"`,
with its loss over the first half of each batch; `fault="rows"` is no
fault but a witness, the reference with each batch's rows in reverse
order, a float32 computation as valid as the reference's, whose gaps are
the rounding noise of each number.
"""

from __future__ import annotations

import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import weights
from portbench.reference import bat as ref_bat
from portbench.reference import bat_train as ref
from portbench.reference import common
from portbench.reference import siamese_samples as ss
from portbench.traffic import train, tracklets
from portbench.traffic.scan_eval import _frames

CHECKED_STEPS = train.CHECKED_STEPS

window, release = train.window, train.release


def setup(run) -> None:
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.train import trainer as trainer_mod

    dev = run.devices[0]
    run.cfg["seed"] = run.seed % (2**31 - 1)
    run.cfg["device_sampler"] = bool(run.mix["device_sampler"])
    work = tempfile.mkdtemp(prefix="portbench-train-")
    run.cfg["log_dir"] = work
    cfg = run.port_config()
    sd = weights.make(ref_bat.param_specs(run.cfg), run.seed, dev)
    model = get_model(run.cfg["net_model"])(cfg, device=dev)
    model.net.load_state_dict(sd)
    run.phase("model")
    data = tracklets.generate(run.mix, run.seed)
    sampler = SimpleNamespace(dataset=train._Frames(_frames(data)))
    run.phase("traffic")
    trainer = trainer_mod.Trainer(model, cfg, work_dir=work, log_every=10**9)
    st = run.state = {"data": data, "model": model, "trainer": trainer, "sampler": sampler,
                      "work": work, "calls": 0, "loss": [], "record": False, "watch": False}
    train._spy(run, trainer_mod, trainer, model)
    train._fit(run, int(run.mix["warmup"]))
    run.phase("fit_warmup")
    t0 = time.perf_counter()
    train._fit(run, int(run.mix["rate_steps"]))
    st["rate"] = int(run.mix["rate_steps"]) / (time.perf_counter() - t0)
    # the parameters the window starts from, which the reference starts from
    st["p0"] = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    run.phase("fit_rate")


def _reference_steps(run, sd, dev, steps: int = CHECKED_STEPS, fault: str = None) -> dict:
    """The reference's first `steps` steps of a `fit` from the parameters
    `sd`: losses, first gradients, parameters after; `fault` as `control`'s."""
    cfg = run.cfg
    data = run.state["data"]
    B = int(cfg["batch_size"])
    nc = int(cfg.get("num_candidates", 1))
    n_samples = sum(len(t["points"]) for t in data) * nc
    p = {n: sd[n].detach().clone().to(dev).requires_grad_() for n in ref.leaves(sd)}
    opt = torch.optim.Adam(list(p.values()), lr=float(cfg["lr"]), betas=(0.5, 0.999), eps=1e-6,
                           weight_decay=float(cfg.get("wd", 0.0) or 0.0))
    out = {"loss": []}
    for s in range(steps):
        rows = ss.loader_rows(n_samples, B, int(cfg["seed"]), 0, s)
        raw = {k: torch.from_numpy(v).to(dev) for k, v in
               ss.raw_batch(data, rows, nc, int(cfg.get("max_raw_points", 2048))).items()}
        batch = ss.build(cfg, raw, ss.step_key(cfg["seed"], s))
        if fault == "half":
            batch = {k: v[: B // 2] for k, v in batch.items()}
        elif fault == "rows":
            batch = {k: v.flip(0) for k, v in batch.items()}
        loss = ref.loss(cfg, batch, ref.train_forward(p, cfg, batch["template_points"],
                                                      batch["search_points"],
                                                      batch["points2cc_dist_t"]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if s == 0:
            out["g1"] = {n: t.grad.detach().clone() for n, t in p.items()}
        opt.step()
        out["loss"].append(float(loss.detach()))
    out["p3"] = {n: t.detach().clone() for n, t in p.items()}
    return out


def _compare(run, prog: dict, want: dict) -> None:
    p0 = run.state["p0"]
    names = list(want["g1"])

    def norms(d, keys):
        return np.array([float(torch.linalg.vector_norm(d[n].double().cpu())) for n in keys])

    def gaps(a, b):
        return np.abs(a - b) / np.maximum(b, np.median(b))

    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"])]
    g_ref = norms(want["g1"], names)
    grad = gaps(norms(prog["g1"], names), g_ref)
    kept = [n for n, g in zip(names, g_ref) if g >= 1e-3 * np.median(g_ref)]
    change = gaps(norms({n: prog["p3"][n].cpu() - p0[n].cpu() for n in kept}, kept),
                  norms({n: want["p3"][n].cpu() - p0[n].cpu() for n in kept}, kept))
    run.counters.update(leaves=len(names), leaves_kept=len(kept), loss_gap_steps=max(losses),
                        median_change_gap=float(np.median(change)))
    for name, value in (("first_loss_gap", losses[0]), ("grad_gap", float(np.max(grad))),
                        ("change_gap", float(np.max(change)))):
        run.check(name, value if np.isfinite(value) else np.inf, float(run.limits[name]))


def check(run) -> None:
    common.plain_precision()
    _compare(run, run.state, _reference_steps(run, run.state["p0"], run.devices[0]))


def control(run, fault: str = None) -> None:
    """The reference in the program's place: the set-up's two fits in
    float32 from the seed's weights, then the window's first three steps in
    TF32, or in float32 with `fault` 'half' (each loss over the first half of
    the batch only) or 'rows' (each batch's rows reversed: a witness, no
    fault), held to the reference's float32 steps from that state."""
    dev = run.devices[0]
    run.cfg["seed"] = run.seed % (2**31 - 1)
    sd = weights.make(ref_bat.param_specs(run.cfg), run.seed, dev)
    run.state = {"data": tracklets.generate(run.mix, run.seed)}
    common.plain_precision()
    for steps in (int(run.mix["warmup"]), int(run.mix["rate_steps"])):
        sd = dict(sd, **_reference_steps(run, sd, dev, steps)["p3"])
    run.state["p0"] = {n: v.detach().cpu() for n, v in sd.items()}
    if fault is None:
        common.tf32_precision()
    prog = _reference_steps(run, sd, dev, fault=fault)
    common.plain_precision()
    _compare(run, prog, _reference_steps(run, sd, dev))

