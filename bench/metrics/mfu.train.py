"""Model flops of the window's train steps over the window's seconds, as
a share of the H100's dense bf16 peak (989 TFLOP/s at 700 W): the frozen
count of ``bench/harness/modelflops.py``, 3 times the forward, no
recompute."""
from bench.harness import modelflops as MF
from bench.harness.yardstick import PEAK_BF16_FLOPS


def read(run):
    if run["kind"] != "train":
        return None
    flops = run["steps"] * MF.train_step_flops(run["model"], run["batch"],
                                               run["seq"])
    return flops / run["window_s"] / PEAK_BF16_FLOPS * 100
