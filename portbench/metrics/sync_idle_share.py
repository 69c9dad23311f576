"""Engine loop: the share of the profiled frame's wall in which the
device sat idle while the host was outside the `steps` and `refresh`
spans: in the loop's round trips and bookkeeping. The program's host
spans (dem_engine_tpu_torch.tracing, its first frame run under the
profiler) are put on the profile's clock by one offset fitted on the
host reads of device values, and each idle stretch goes to the innermost
span open over it (portbench/spans.py)."""

from portbench import spans


def read(rec):
    return spans.sync_idle_share(rec)
