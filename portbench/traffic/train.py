"""Traffic runner `train`: the port's `Trainer.fit` with its samples built on
the card (`device_sampler: true`).

Set-up makes the configuration's weights and the mix's training tracklets
from the seed (the run's seed is also the configuration's `seed`, which
keys the loader's shuffle and the builder's draws), builds one `Trainer`
around the model, and runs two `fit` calls of one epoch each on it: the
first of `warmup` steps (Adam's state, cuBLAS plans, the sampler's first
batches), the second of `rate_steps` steps, whose rate sizes the window.
The window is one more `fit` call on the same trainer and model, of as many
steps as that rate fills in `--seconds`; `train_samples_per_s` is its rows
over its wall time (every step finished: `fit` synchronises; its epoch's
checkpoint, one file under TMPDIR written over each call, is part of it).

The check holds the window's own first three steps to the plain reference
(portbench/reference/m2track.py training path, motion_samples.py for the
samples). Every `fit` builds a fresh Adam, restarts its loader at epoch 0
and draws the builder's keys from step 0, so the reference, started from
the parameters the window starts from (copied at the end of set-up),
follows the window's steps. They are recorded as the window runs them,
with no synchronisation added: each step's loss tensor, Adam's first moment
after the first step (over 1 - beta1: the first gradient as Adam got it)
and the parameters after the third, copied on the card. Compared: each
step's loss, the first gradient leaf by leaf, and every parameter's change
over the three steps, by the worst leaf's gap of norms against the larger
of that leaf's reference norm and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's (a Dense
bias ahead of a batch-statistics BatchNorm, whose exact gradient is 0) move
by round-off alone and are left out of the change. The control (`control`)
is the reference in the program's place, from the state the reference
reaches through the set-up's two fits: in TF32, or, with `fault="half"`,
with its loss over the first half of each batch.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import stats, weights
from portbench.reference import common
from portbench.reference import m2track as ref
from portbench.reference import motion_samples as ms
from portbench.traffic import tracklets
from portbench.traffic.scan_eval import _frames

CHECKED_STEPS = 3


class _Frames:
    """The tracklets as a training dataset (what the raw motion sampler reads)."""

    def __init__(self, seqs):
        self.seqs = seqs
        self.tracklet_anno_list = [[None] * len(s) for s in seqs]

    def get_num_tracklets(self):
        return len(self.seqs)

    def get_num_frames_tracklet(self, i):
        return len(self.seqs[i])

    def get_frames(self, seq_id, frame_ids):
        return [self.seqs[seq_id][f] for f in frame_ids]


def setup(run) -> None:
    from open3dsot_tpu_torch.models import get_model
    from open3dsot_tpu_torch.train import trainer as trainer_mod

    dev = run.devices[0]
    run.cfg["seed"] = run.seed % (2**31 - 1)
    work = tempfile.mkdtemp(prefix="portbench-train-")
    run.cfg["log_dir"] = work
    cfg = run.port_config()
    sd = weights.make(ref.param_specs(), run.seed, dev)
    model = get_model(run.cfg["net_model"])(cfg, device=dev)
    model.net.load_state_dict(sd)
    run.phase("model")
    data = tracklets.generate(run.mix, run.seed)
    sampler = SimpleNamespace(dataset=_Frames(_frames(data)))
    run.phase("traffic")
    trainer = trainer_mod.Trainer(model, cfg, work_dir=work, log_every=10**9)
    st = run.state = {"data": data, "model": model, "trainer": trainer, "sampler": sampler,
                      "work": work, "calls": 0, "loss": [], "record": False, "watch": False}
    _spy(run, trainer_mod, trainer, model)
    _fit(run, int(run.mix["warmup"]))
    run.phase("fit_warmup")
    t0 = time.perf_counter()
    _fit(run, int(run.mix["rate_steps"]))
    st["rate"] = int(run.mix["rate_steps"]) / (time.perf_counter() - t0)
    # the parameters the window starts from, which the reference starts from
    st["p0"] = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    run.phase("fit_rate")


def _fit(run, steps: int):
    st = run.state
    return st["trainer"].fit(st["sampler"], None, epochs=1, steps_per_epoch=steps)


def _spy(run, trainer_mod, trainer, model) -> None:
    """Spans around the step and the sample build; the window's first three
    steps' loss tensors, the first step's first moments and the third's
    parameters recorded, each copied on the card as the window runs (the
    step's own `fetch` unchanged)."""
    st = run.state
    step = trainer_mod.train_step
    device_sampler = trainer._device_sampler
    loss_fn = model.loss

    def loss(batch, output):
        terms = loss_fn(batch, output)
        if st["watch"]:
            st["loss"].append(terms["loss_total"].detach())
        return terms

    def train_step(model, optimizer, batch, scheduler=None, fetch=False, per_device_stats=False):
        k = st["calls"]
        st["calls"] += 1
        st["watch"] = st["record"] and k < CHECKED_STEPS
        with run.spans.span("train.step"):
            out = step(model, optimizer, batch, scheduler, fetch, per_device_stats)
        if st["watch"]:
            if k == 0:
                st["beta1"] = optimizer.param_groups[0]["betas"][0]
                st["g1"] = {n: optimizer.state[p]["exp_avg"].clone()
                            for n, p in model.net.named_parameters()}
            if k == CHECKED_STEPS - 1:
                st["p3"] = {n: p.detach().clone() for n, p in model.net.named_parameters()}
        st["watch"] = False
        return out

    def spanned_sampler(train_sampler):
        raw, build, transform = device_sampler(train_sampler)

        def spanned(raw_batch, key):
            with run.spans.span("train.build"):
                return build(raw_batch, key)

        return raw, spanned, transform

    trainer_mod.train_step = train_step
    model.loss = loss
    st["restore"] = lambda: setattr(trainer_mod, "train_step", step)
    trainer._device_sampler = spanned_sampler


def window(run, seconds: float) -> None:
    st = run.state
    steps = max(CHECKED_STEPS, int(round(seconds * st["rate"])))  # the check holds the first three
    run.spans.records.clear()
    st["calls"], st["record"] = 0, True
    t0 = time.perf_counter()
    history = _fit(run, steps)
    elapsed = time.perf_counter() - t0
    rows = steps * int(run.cfg["batch_size"])
    run.e2e["train_samples_per_s"] = stats.rate(rows, elapsed)
    run.counters.update(steps=steps, rows=rows, window_s=elapsed, history=history[-1],
                        cfg=run.cfg)
    run.attempted = rows


def release(run) -> None:
    st = run.state
    st["restore"]()
    shutil.rmtree(st["work"], ignore_errors=True)
    if len(st["loss"]) < CHECKED_STEPS or "p3" not in st:
        raise RuntimeError(f"the window ran {len(st['loss'])} of the {CHECKED_STEPS} steps "
                           f"that are checked")
    run.state = {"data": st["data"], "loss": [float(x) for x in st["loss"]],
                 "p0": {n: v.cpu() for n, v in st["p0"].items()},
                 "g1": {n: (v / (1.0 - st["beta1"])).cpu() for n, v in st["g1"].items()},
                 "p3": {n: v.cpu() for n, v in st["p3"].items()}}


def _reference_steps(run, sd, dev, steps: int = CHECKED_STEPS, half: bool = False) -> dict:
    """The reference's first `steps` steps of a `fit` from the parameters
    `sd`: losses, first gradients, parameters after."""
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
        rows = ms.loader_rows(n_samples, B, int(cfg["seed"]), 0, s)
        raw = {k: torch.from_numpy(v).to(dev) for k, v in
               ms.raw_batch(data, rows, nc, int(cfg.get("max_raw_points", 2048))).items()}
        batch = ms.build(cfg, raw, ms.step_key(cfg["seed"], s))
        if half:
            batch = {k: v[: B // 2] for k, v in batch.items()}
        loss = ref.loss(cfg, batch, ref.train_forward(p, batch["points"], batch["candidate_bc"]))
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

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"]))
    g_ref, g_prog = norms(want["g1"], names), norms(prog["g1"], names)
    grad_gap = float(np.max(np.abs(g_prog - g_ref) / np.maximum(g_ref, np.median(g_ref))))
    kept = [n for n, g in zip(names, g_ref) if g >= 1e-3 * np.median(g_ref)]
    d_ref = norms({n: want["p3"][n].cpu() - p0[n].cpu() for n in kept}, kept)
    d_prog = norms({n: prog["p3"][n].cpu() - p0[n].cpu() for n in kept}, kept)
    change_gap = float(np.max(np.abs(d_prog - d_ref) / np.maximum(d_ref, np.median(d_ref))))
    run.counters.update(leaves=len(names), leaves_kept=len(kept))
    for name, value in (("loss_gap", loss_gap), ("grad_gap", grad_gap),
                        ("change_gap", change_gap)):
        run.check(name, value if np.isfinite(value) else np.inf, float(run.limits[name]))


def check(run) -> None:
    common.plain_precision()
    _compare(run, run.state, _reference_steps(run, run.state["p0"], run.devices[0]))


def control(run, fault: str = None) -> None:
    """The reference in the program's place: it runs the set-up's two fits in
    float32 from the seed's weights, then the window's first three steps in
    TF32, or (fault 'half') in float32 with each loss over the first half of
    the batch only, held to the reference's float32 steps from that state."""
    dev = run.devices[0]
    run.cfg["seed"] = run.seed % (2**31 - 1)
    sd = weights.make(ref.param_specs(), run.seed, dev)
    run.state = {"data": tracklets.generate(run.mix, run.seed)}
    common.plain_precision()
    for steps in (int(run.mix["warmup"]), int(run.mix["rate_steps"])):
        sd = dict(sd, **_reference_steps(run, sd, dev, steps)["p3"])
    run.state["p0"] = {n: v.detach().cpu() for n, v in sd.items()}
    if fault == "half":
        prog = _reference_steps(run, sd, dev, half=True)
    else:
        common.tf32_precision()
        prog = _reference_steps(run, sd, dev)
    common.plain_precision()
    _compare(run, prog, _reference_steps(run, sd, dev))
