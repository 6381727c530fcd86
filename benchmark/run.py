"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from this module's first line): the weights
are drawn from ``--seed`` on the card, the program's predictor is built from
the configuration file with them, the frame pool is drawn from the seed, and
the traffic mix's warm-up batches run through the same call as the window's.
Then the window: a closed loop of ``DensePosePredictor.predict_batch`` on B
distinct frames handed over from host memory, each batch timed from the call
until its ``det_packed`` is on the host and the device is synchronised; no
batch starts after ``--seconds``. The DensePose maps stay on the card, apart
from those of the batches sampled for the check, which a side stream copies
into pinned host memory while the next batch runs. With ``--trace 1`` a
``torch.profiler`` trace covers a stretch of the window, and the per-layer
metrics are read from it.

After the window the peak memory is read and the program is freed; then the
plain reference (``reference/``) recomputes the sampled frames from the same
weights and frames, and ``check.py`` decides ``correct``. The last line of
standard output is the result; the last lines of standard error, and the
result's ``compared`` key, give each number compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import check, frames, manifest, readers, trace, weights  # noqa: E402
from .reference import model as reference  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "densepose_tpu"}
STAGES = ("preprocess", "backbone", "rpn", "box_stage", "postprocess", "decoder",
          "densepose_pooler", "densepose_head", "densepose_predictor")
MAP_KEYS = {k: f"pred_densepose_{k}" for k in check.MAPS}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def program_config(conf: dict, control: bool):
    """The program's config: the zoo entry with the configuration file's
    ``opts`` (and the control's), checked key by key against ``model``."""
    from densepose_tpu_torch.model_zoo import get_config
    opts = dict(conf["opts"])
    if control:
        opts.update(conf["control"]["opts"])
    cfg = get_config(conf["zoo"]).clone()
    cfg.defrost()
    cfg.merge_from_list([v for kv in opts.items() for v in kv])
    cfg.freeze()
    bad = manifest.check_config(conf, cfg)
    if bad and not control:
        raise ValueError(f"the program's config differs from the configuration file: {bad}")
    return cfg


def batch_is_sound(det: np.ndarray) -> bool:
    """Every value finite and each frame's count equal to its valid rows."""
    if not np.isfinite(det).all():
        return False
    return bool((det[:, -1, 0] == (det[:, :-1, 6] > 0.5).sum(1)).all())


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        return out.splitlines()[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(m: dict, cell: dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
             conf: Optional[dict] = None, traffic: Optional[dict] = None, control: bool = False,
             wrap: Optional[Callable] = None, t_start: float = T_START) -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``conf`` / ``traffic`` replace the cell's files, ``control`` serves the
    configuration's control instead of the program as configured, and
    ``wrap(predict_batch)`` stands between the loop and the program (the
    tests plant faults there)."""
    import torch
    from torch.profiler import record_function

    from densepose_tpu_torch.predictor import DensePosePredictor

    conf = conf or manifest.config(m, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    b = int(traffic["batch"])

    cfg = program_config(conf, control)
    shapes = reference.state_shapes(conf["model"])
    params = weights.host_params(weights.make_weights(shapes, conf["init"], seed, device,
                                                      conf["dtype"]))
    pred = DensePosePredictor(cfg, device=device, params=params)
    del params
    pool = frames.FramePool(traffic, seed)
    warm = int(traffic["warmup_batches"])
    if control and conf["control"].get("calibrate_frames"):
        calib = [pool.batch(0)[j].copy() for j in range(int(conf["control"]["calibrate_frames"]))]
        pred.calibrate_int8(calib)
    predict = wrap(pred.predict_batch) if wrap else pred.predict_batch

    def one(index: int):
        with record_function(trace.BATCH_RANGE):
            x = pool.batch(index)
            t0 = time.perf_counter()
            with record_function("bench.call"):
                out = predict(x)
            t1 = time.perf_counter()
            with record_function("bench.fetch"):
                det = out["det_packed"].cpu()
                sync()
            t2 = time.perf_counter()
        return out, det.numpy(), t1 - t0, t2 - t0

    out = None
    for i in range(warm):
        out = one(i)[0]
    # the sample checked: drawn from the seed among the window's batches after
    # the traced ones (so that no check copy lies in a trace), as many as
    # check_batches_per_s of the window give
    n_trace = int(traffic["trace_batches"])
    n_pool = max(1, int(seconds * traffic["check_batches_per_s"]))
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0x636B])
    sample = sorted(n_trace + int(i) for i in rng.choice(
        n_pool, size=min(int(traffic["check_batches"]), n_pool), replace=False))
    # pinned host buffers for the sampled batches' maps, shaped as a warm batch's
    host_maps = {i: {k: torch.empty(out[MAP_KEYS[k]].shape, dtype=out[MAP_KEYS[k]].dtype,
                                    pin_memory=cuda) for k in check.MAPS} for i in sample}
    side = torch.cuda.Stream() if cuda else None
    del out
    sync()

    prof = None
    if traced:
        # the profiler starts in set-up, on one more warm batch, and records
        # the window's first trace_batches batches
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=n_trace,
                                                          repeat=1))
        prof.start()
        warm += 1
        one(warm - 1)
        prof.step()
    elem = torch.empty((), dtype=weights.DTYPES[conf["dtype"]]).element_size()
    run = readers.Run(cfg=conf["model"], traffic=traffic, batch=b, elem_bytes=elem)
    comparison = check.Comparison(traffic["frame_hw"], conf["model"])
    dets, failed, pending = [], 0, None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    i = 0
    while True:
        out, det, submit, latency = one(warm + i)
        if prof is not None and i < n_trace:
            prof.step()
        elif prof is not None:
            run.submit_s.append(submit)
        if pending is not None:
            pending[1].synchronize()
            pending = None
        if i in host_maps:
            if cuda:
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for k in check.MAPS:
                        host_maps[i][k].copy_(out[MAP_KEYS[k]], non_blocking=True)
                pending = (out, side.record_event())
            else:
                for k in check.MAPS:
                    host_maps[i][k].copy_(out[MAP_KEYS[k]])
        dets.append(det)
        failed += 0 if batch_is_sound(det) else b
        run.latencies_ms.append(latency * 1e3)
        i += 1
        if time.perf_counter() - t_window >= seconds:
            break
    run.window_s = time.perf_counter() - t_window
    run.frames = i * b
    if prof is not None and i < n_trace:
        prof.stop()
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if pending is not None:
        pending[1].synchronize()
    del out, pending, pred, predict
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    if prof is not None:
        run.trace = trace.summarize(trace.from_profiler(prof), STAGES)
        del prof
    t_ref = time.perf_counter()
    # the check: every batch's image sizes; the sampled batches against the reference
    for det in dets:
        comparison.headers(det)
    reference.set_precision_flags()
    w = weights.make_weights(shapes, conf["init"], seed, device, conf["dtype"])
    checked = 0
    for i in sample:
        if i >= len(dets):
            continue
        x = pool.batch(warm + i)
        for j in range(b):
            found = reference.detect(conf["model"], w, torch.from_numpy(x[j].copy()).to(device))
            ref = {k: found[k].cpu().numpy() for k in
                   ("image_size", "net", "boxes", "scores", "classes", "valid", "keep")}

            def ref_maps(rows, found=found):
                got = reference.maps_at(conf["model"], w, found,
                                        torch.as_tensor(rows, device=device))
                return {k: v.float().cpu().numpy() for k, v in got.items()}

            got = {k: host_maps[i][k][j].float().numpy() for k in check.MAPS}
            comparison.frame(dets[i][j], got, ref, ref_maps)
            checked += 1
            del found
    del w
    t_done = time.perf_counter()
    numbers = comparison.numbers()
    limits = conf["limits"]
    correct = check.verdict(numbers, limits) and failed == 0 and checked > 0

    metrics = {}
    for mdef in manifest.metrics_of(m, cell["name"], traced):
        value = manifest.reader(mdef["name"])(run)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(correct), "attempted": run.frames, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        dev["attributed"] = run.trace["attributed"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    if cuda:
        dev["card"] = card_line()
    result["checked_frames"] = checked
    result["diagnostics"] = comparison.details()
    result["timing_s"] = {"setup": run.setup_s, "window": run.window_s,
                          "trace": t_ref - t_check, "reference": t_done - t_ref}
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    return result


def clean(obj):
    """The result with NaN (a number that could not be read) as null."""
    if isinstance(obj, dict):
        return {k: clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [clean(v) for v in obj]
    if isinstance(obj, float) and math.isnan(obj):
        return None
    return obj


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(4)
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(m, cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
