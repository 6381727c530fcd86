"""Seconds from the harness's first line to the first timed batch: imports,
weights, the model's build and upload, the kernels' build where it is not
cached, and the warm-up batches."""


def read(run):
    return run.setup_s
