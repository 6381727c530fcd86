"""What the metric readers under ``metrics/`` share: the record of one run
and the arithmetic on it. A reader returns None where its run has nothing
for it to read (a per-layer metric in a run without a trace, a stage that
did not run), and the harness then leaves the metric out."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from . import parts
from .counts import kernels, model, shapes


@dataclass
class Run:
    cfg: dict                        # the configuration file's ``model`` keys
    traffic: dict
    batch: int
    elem_bytes: int                  # bytes of an element in the served dtype
    setup_s: float = 0.0
    frames: int = 0                  # frames completed in the window
    window_s: float = 0.0
    latencies_ms: List[float] = field(default_factory=list)
    peak_bytes: int = 0
    trace: Optional[dict] = None     # trace.summarize of the traced stretch
    submit_s: List[float] = field(default_factory=list)  # host seconds of each traced call

    @property
    def canvas(self):
        return shapes.canvas(self.cfg, self.traffic["frame_hw"])

    @property
    def trace_frames(self) -> int:
        return self.trace["batches"] * self.batch if self.trace else 0


def traced(run: Run) -> bool:
    """A trace in which the device ran something."""
    return bool(run.trace) and run.trace["busy_s"] > 0


def stage_ms(run: Run, stage: str) -> Optional[float]:
    """Device ms a frame under one of the program's stage ranges."""
    if not traced(run) or stage not in run.trace["stage_s"]:
        return None
    return run.trace["stage_s"][stage] * 1e3 / run.trace_frames


def roofline(run: Run, bound_per_batch, include: str, exclude: str = "\0"):
    """% of the least time (``bound_per_batch(run)`` seconds a batch, summed
    over the traced batches) in the device time of the kernels named by
    ``include``."""
    if not traced(run):
        return None
    from .trace import kernel_s
    spent = kernel_s(run.trace, include, exclude)
    if spent <= 0:
        return None
    return 100.0 * bound_per_batch(run) * run.trace["batches"] / spent


def k1_bound_per_batch(run: Run) -> float:
    """Both K1 launches of a batch: the RPN's (every frame's level
    problems) and the box stage's (every frame's class problems)."""
    rpn = shapes.rpn_problem_sizes(run.cfg, run.canvas) * run.batch
    box = shapes.box_problem_sizes(run.cfg) * run.batch
    return sum(kernels.bound_s(*kernels.k1_work(p)) for p in (rpn, box))


def k2_bound_per_batch(run: Run) -> float:
    """Both K2 launches of a batch: the box pooler (POST_NMS_TOPK_TEST
    proposals a frame) and the DensePose pooler (every DensePose slot)."""
    c = run.cfg
    b = "MODEL.ROI_BOX_HEAD."
    dp = "MODEL.ROI_DENSEPOSE_HEAD."
    box = kernels.k2_work(c["MODEL.RPN.POST_NMS_TOPK_TEST"] * run.batch,
                          parts.backbone(c).out_channels(c), c[b + "POOLER_RESOLUTION"],
                          c[b + "POOLER_SAMPLING_RATIO"], run.elem_bytes)
    dense = kernels.k2_work(c["TEST.DETECTIONS_PER_IMAGE"] * run.batch, parts.head_in_channels(c),
                            c[dp + "POOLER_RESOLUTION"], c[dp + "POOLER_SAMPLING_RATIO"],
                            run.elem_bytes)
    return kernels.bound_s(*box) + kernels.bound_s(*dense)


def flops_per_frame(run: Run) -> float:
    return model.forward_flops(run.cfg, run.canvas)["total"]

