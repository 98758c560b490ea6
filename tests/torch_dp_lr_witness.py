"""Why ``test_trainer_run_two_ranks_equals_one`` trains at INIT_LR 1e-5:
the float32 rounding of its random-weight run, amplified at the usual
0.01, and not a difference between two ranks and one process.

At INIT_LR 0.01 the test's config (YOLOv5-n at 64², ``DEVICE_AUG``, two
epochs of two steps at a global batch of 8) runs five times on the CPU:

* one process on one intra-op thread, the reference;
* one process on four threads (the same arithmetic in another float32
  reduction order);
* two gloo ranks (``torch_dp_ranks.RankPool``);
* one process and two ranks again, with the model trained in float64.

It prints, as one JSON object, each run's step losses relative to the
reference's, its largest parameter difference relative to the largest
parameter and the test's form of the four updates' difference
(``assert_grads_close``'s).  Reduction order alone moves a float32 run
by the same kind of amount as two ranks do; in float64 the two ranks
equal one process to rounding, so the float32 gap is rounding amplified,
not a semantic one (their logged losses are float32 still, so those
agree to float32's rounding).

    JAX_PLATFORMS=cpu python -m tests.torch_dp_lr_witness   # ~35 s
"""
from __future__ import annotations

import json
import pathlib
import tempfile

import numpy as np
import torch

from tests import torch_dp_ranks as ranks_mod

LR = 0.01


def _run_one(setting: str, workdir: pathlib.Path, name: str, threads: int,
             float64: bool) -> dict:
    body = json.loads(open(setting).read())
    body["CHECKPOINT_DIR"] = str(workdir / name)
    path = workdir / f"{name}.json"
    path.write_text(json.dumps(body))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return ranks_mod.job_trainer_run(str(path), float64)
    finally:
        torch.set_num_threads(before)


def _compare(got: dict, want: dict) -> dict:
    params = [k for k, v in want["model"].items() if v.dtype.kind == "f"]
    top = max(float(np.abs(want["model"][k]).max()) for k in params)
    moved = lambda run: {k: run["model"][k] - run["initial"][k] for k in params}
    g, w = moved(got), moved(want)
    moved_top = max(float(np.abs(v).max()) for v in w.values())
    update_err = max(float(np.abs(g[k] - v).max())
                     / max(float(np.abs(v).max()), 1e-3 * moved_top) for k, v in w.items())
    return {"loss_rel_by_step": [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                 for a, b in zip(got["logged"], want["logged"], strict=True)],
            "param_rel": max(float(np.abs(got["model"][k] - want["model"][k]).max())
                             for k in params) / top,
            "update_err": update_err}


def main() -> None:
    # the ranks re-import this module, and they must not import JAX
    from tests.test_torch_parallel_dp import trainer_run_setting

    torch.set_num_threads(1)
    out = {"init_lr": LR}
    with tempfile.TemporaryDirectory(prefix="dp_lr_witness_") as tmp:
        workdir = pathlib.Path(tmp)
        setting = trainer_run_setting(workdir, LR)
        pool = ranks_mod.RankPool(2)
        try:
            for dtype, float64 in (("float32", False), ("float64", True)):
                ref = _run_one(setting, workdir, f"one_{dtype}", 1, float64)
                body = json.loads(open(setting).read())
                body["CHECKPOINT_DIR"] = str(workdir / f"two_{dtype}")
                path = workdir / f"two_{dtype}.json"
                path.write_text(json.dumps(body))
                two = pool.run("job_trainer_run", str(path), float64, timeout=300)[0]
                out[f"{dtype}_two_ranks_vs_one_process"] = _compare(two, ref)
                if not float64:
                    four = _run_one(setting, workdir, "one_float32_t4", 4, False)
                    out["float32_four_threads_vs_one_thread"] = _compare(four, ref)
        finally:
            pool.close()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
