"""The 90th percentile of every round of a traced window, measured as
``train_round_ms_p90`` measures it: the tail of a cell whose rounds are
set by the host's issue, which spreads from one process to the next by
more than a bound could hold, is read here without one."""
import pb_spec


def read(ctx):
    return pb_spec.reader("train_round_ms_p90")(ctx)
