"""The benchmark's yardstick: the card's peaks and the kernels' work
formulas, frozen here so that a change to the program cannot move the
ruler it is measured with (the model-flop count is
``bench/harness/modelflops.py`` over each family's file).

The two ``*_work`` functions are copies of the port's
``kernels/flash_attention/ops.py:work`` and ``kernels/ssd_scan/ops.py:work``
as they stood when the benchmark was defined; ``test_bench_yardstick.py``
holds them equal to the port's at the shapes the cells run.  Nothing here
imports the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs one head of one sequence attends."""
    if not causal:
        return Sq * Sk
    if not window or window >= Sq:
        return Sq * (Sq + 1) // 2
    return window * (window + 1) // 2 + (Sq - window) * window


def flash_work(B: int, Sq: int, Sk: int, H: int, K: int, d: int, *,
               causal: bool, window: int = 0, itemsize: int = 2,
               backward: bool = False, with_lse: bool = False) -> dict:
    """Least flops and bytes of the attention forward, or of its backward
    pair, at q [B, Sq, H, d] and k/v [B, Sk, K, d]: 2 d flops a visible
    pair for each product, each input read and each output written once."""
    pairs = B * H * visible_pairs(Sq, Sk, causal, window)
    n_q, n_kv, n_rows = B * Sq * H * d, B * Sk * K * d, B * H * Sq
    if backward:
        return {"flops": 5 * 2 * d * pairs,
                "bytes": (4 * n_q + 4 * n_kv) * itemsize + 4 * n_rows}
    return {"flops": 2 * 2 * d * pairs,
            "bytes": (2 * n_q + 2 * n_kv) * itemsize
            + (4 * n_rows if with_lse else 0)}


def ssd_work(B: int, S: int, H: int, P: int, N: int, chunk: int, *,
             itemsize: int = 2, backward: bool = False,
             with_states: bool = False, init_state: bool = False) -> dict:
    """Least flops and bytes of the SSD chunk scan forward, or of its
    backward, at x [B, S, H, P] and B/C [B, S, N] (dt, A, the states in
    f32)."""
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        tri = q * (q + 1) // 2
        flops += B * 2 * N * tri
        flops += B * H * ((4 * P * tri + 4 * N * tri + 8 * q * P * N)
                          if backward
                          else (2 * P * tri + 2 * q * N * P + 2 * q * P * N))
    n_x, n_bc, n_dt = B * S * H * P, B * S * N, B * S * H
    state = B * H * P * N * 4
    chunk_states = -(-S // chunk) * state
    if backward:
        nbytes = (3 * n_x + 4 * n_bc) * itemsize + 2 * n_dt * 4 + 2 * H * 4 \
            + chunk_states + (state if init_state else 0)
    else:
        nbytes = (2 * n_x + 2 * n_bc) * itemsize + n_dt * 4 + H * 4 + state \
            + (state if init_state else 0) \
            + (chunk_states if with_states else 0)
    return {"flops": flops, "bytes": nbytes}


def bound_s(work: dict) -> float:
    """The least time the card could take: the longer of the flops over
    the bf16 peak and the bytes over the HBM rate."""
    return max(work["flops"] / PEAK_BF16_FLOPS,
               work["bytes"] / HBM_BYTES_PER_S)
