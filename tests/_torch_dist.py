"""A two-rank gloo world for the tests of the port's multi-device runs
(tests/test_torch_distributed*.py): `run_world(jobs, tmp)` starts the ranks
(processes that import torch and the port only), each runs every job and
writes its results, which come back by rank."""

from __future__ import annotations

import pickle
from pathlib import Path

from open3dsot_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parents[1]

WORKER = r'''
import pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
from open3dsot_tpu_torch.parallel import distributed


def model_of(job):
    from open3dsot_tpu_torch.config import make_config
    from open3dsot_tpu_torch.models import get_model

    cfg = make_config(job["cfg"])
    model = get_model(cfg.net_model)(cfg, device="cpu")
    model.net.load_state_dict(job["state_dict"])
    return model, cfg


def rows_of(arrays: dict) -> dict:
    r, n = distributed.rank(), distributed.world_size()
    b = next(iter(arrays.values())).shape[0] // n
    return {k: torch.from_numpy(np.asarray(v))[r * b:(r + 1) * b] for k, v in arrays.items()}


def run_eval(job):
    from open3dsot_tpu_torch.data import get_dataset
    from open3dsot_tpu_torch.tracking.eval import evaluate_dataset

    model, cfg = model_of(job)
    sampler = get_dataset(cfg, "test", "test")
    if job["path"] == "host":
        return evaluate_dataset(model, sampler, cfg, shard_across_processes=True)
    return model.evaluate_scan(sampler, cfg, tracker=model.scan_tracker(cfg, **job["kw"]),
                               shard_across_processes=True)


def run_train(job):
    from open3dsot_tpu_torch.train.trainer import train_step

    model, cfg = model_of(job)
    model.net.double()
    batch = {k: v.double() for k, v in rows_of(job["batch"]).items()}
    opt = torch.optim.SGD(model.net.parameters(), lr=1.0)
    losses = train_step(model, opt, batch, fetch=True, per_device_stats=job["per_device"])
    return losses, {k: v.numpy() for k, v in model.net.state_dict().items()}


def run_k6(job):
    from open3dsot_tpu_torch.ops import sa_fused_train as k6

    x = rows_of(job["rows"])
    w = {k: torch.from_numpy(v) for k, v in job["weights"].items()}
    bn = [w[k] for k in ("g1", "bt1", "g2", "bt2", "g3", "bt3")]
    out, stats, grids = k6.sa_train_fwd_plain(x["a"], x["ct"], x["idx"], w["w2"], w["b2"], w["w3"],
                                              w["b3"], bn, global_stats=True)
    grads = k6.sa_train_bwd_plain(x["g"], x["a"], x["ct"], x["idx"], grids, stats, w["w2"],
                                  w["b2"], w["w3"], w["b3"], bn, global_stats=True)
    flat = lambda ts: [t.numpy() for t in ts]
    return out.numpy(), flat(stats), flat(grads[:4]), flat(grads[4])


with open(sys.argv[1], "rb") as f:
    jobs = pickle.load(f)
distributed.init_from_env("cpu", "gloo")
out = {name: globals()["run_" + job["kind"]](job) for name, job in jobs.items()}
with open(f"{sys.argv[2]}.{distributed.rank()}", "wb") as f:
    pickle.dump(out, f)
distributed.shutdown()
'''



def run_world(jobs: dict, tmp: Path, n: int = 2) -> list:
    """Run `jobs` on an n-rank gloo world; -> each rank's results by job."""
    (tmp / "worker.py").write_text(WORKER)
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    code = distributed.launch([str(tmp / "worker.py"), str(tmp / "jobs.pkl"), str(tmp / "out")],
                              n, env={"PYTHONPATH": str(REPO)})
    assert code == 0, f"a rank exited with {code}"
    out = []
    for r in range(n):
        with open(tmp / f"out.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


