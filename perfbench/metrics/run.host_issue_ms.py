"""Host milliseconds inside ``GspmdRun.step`` a round, with no
synchronise: what the host spends issuing a round (mean over the
window's rounds)."""
import statistics


def read(ctx):
    ms = ctx.get("host_issue_ms")
    return statistics.fmean(ms) if ms else None
