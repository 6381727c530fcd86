"""What PyTorch's dispatcher adds to a call of an operator whose kernel is a
Python function, by the kind of arguments in its schema.

    python -m densepose_tpu_torch.tools.dispatch_cost

Defines throwaway operators in a namespace of their own
(``densepose_dispatch_probe``) whose CUDA kernel returns a preallocated
tensor at once, so each call's host time is the dispatcher's and the
argument conversions' alone: one tensor; a tensor list; a float list; an
int pair; the schema of ``densepose_tpu_torch::roi_align`` (K2 and K3), with
its list and with four tensor arguments in its place; and that of
``densepose_tpu_torch::conv_s8`` (Q1). Prints microseconds a call (the best
of 7 rounds of 1000 calls) beside a plain Python call of the same function.
Needs a CUDA device; the port's kernels are not built.
"""

import time

import torch

ROUNDS, CALLS = 7, 1000
SCHEMAS = {
    "one_tensor": "(Tensor x) -> Tensor",
    "tensor_list": "(Tensor[] xs) -> Tensor",
    "float_list": "(Tensor x, float[] s) -> Tensor",
    "int_pair": "(Tensor x, int[2] o) -> Tensor",
    "roi_align": "(Tensor[] xs, Tensor b, Tensor l, float[] s, int[2] o, int r, bool a) -> Tensor",
    "roi_align_four_tensors": "(Tensor x0, Tensor x1, Tensor x2, Tensor x3, Tensor b, Tensor l, "
                              "float s0, float s1, float s2, float s3, int r, bool a) -> Tensor",
    "conv_s8": "(Tensor qx, Tensor qw, Tensor? qb, Tensor? vec, int[2] s, int[2] p, int[2] d, "
               "bool t, bool r, ScalarType o) -> Tensor",
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_cost: no CUDA device")
    out = torch.empty(1, device="cuda")

    def kernel(*args, **kwargs):
        return out

    lib = torch.library.Library("densepose_dispatch_probe", "DEF")
    for name, schema in SCHEMAS.items():
        lib.define(name + schema)
        lib.impl(name, kernel, "CUDA")
    ops = torch.ops.densepose_dispatch_probe
    feats = [torch.randn(256, 8, 8, device="cuda") for _ in range(4)]
    boxes = torch.randn(1000, 4, device="cuda")
    levels = torch.zeros(1000, dtype=torch.int32, device="cuda")
    q = torch.zeros(4, 4, dtype=torch.int8, device="cuda")
    scales = [0.25, 0.125, 0.0625, 0.03125]
    calls = {
        "python_call": lambda: kernel(feats, boxes, levels, scales, [7, 7], 2, True),
        "one_tensor": lambda: ops.one_tensor(boxes),
        "tensor_list": lambda: ops.tensor_list(feats),
        "float_list": lambda: ops.float_list(boxes, scales),
        "int_pair": lambda: ops.int_pair(boxes, [7, 7]),
        "roi_align": lambda: ops.roi_align(feats, boxes, levels, scales, [7, 7], 2, True),
        "roi_align_four_tensors": lambda: ops.roi_align_four_tensors(*feats, boxes, levels,
                                                                      *scales, 2, True),
        "conv_s8": lambda: ops.conv_s8(q, q, None, None, [1, 1], [1, 1], [1, 1], False, True,
                                       torch.int8),
    }
    for fn in calls.values():
        for _ in range(300):
            fn()
    best = dict.fromkeys(calls, float("inf"))
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            best[name] = min(best[name], (time.perf_counter() - t0) / CALLS * 1e6)
    print(f"dispatch_cost on {torch.cuda.get_device_name(0)}, torch {torch.__version__}: host us "
          f"a call, best of {ROUNDS} rounds of {CALLS}")
    for name, us in best.items():
        print(f"  {name}: {us:.2f}")


if __name__ == "__main__":
    main()
