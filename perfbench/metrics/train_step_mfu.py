"""The round's model FLOPs (``pb_flops.round_flops``: 6 × the matmul
parameters a token touches × tokens, plus attention) times the rounds
of the traced run's window, over its wall time, as a share of one
H100's f32 peak without tensor cores (67 TFLOP/s)."""
import pb_flops


def read(ctx):
    if not ctx.get("spans"):
        return None
    return 100.0 * ctx["rounds"] * ctx["flops_per_round"] / ctx["window_s"] / pb_flops.F32_PEAK_FLOPS
