"""Model flops of the window's fresh calls (each prompt's forward and the
decode steps its tokens need) over the window's seconds, as a share of
the H100's dense bf16 peak (989 TFLOP/s at 700 W)."""
from bench.harness import modelflops as MF
from bench.harness.yardstick import PEAK_BF16_FLOPS


def read(run):
    if run["kind"] != "serve":
        return None
    flops = sum(MF.serve_call_flops(run["model"], n, S, run["n_new"])
                for n, S in run["fresh_calls"])
    return flops / run["window_s"] / PEAK_BF16_FLOPS * 100
