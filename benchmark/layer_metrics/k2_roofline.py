"""K2's share of its roofline: the least time of every call of the custom
op ``fused_block_bwd`` in the traced part (benchmark/counts.py's k2_counts
at the call's input shape), over the device time of the kernels each call
launched, linked to it through the launches' correlation ids."""

from benchmark import counts

OP = "audioset_convnext_inf_torch::fused_block_bwd"


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.under_op(OP)
    if not calls:
        return None
    least = sum(counts.least_seconds(*counts.k2_counts(dims[0])) for dims, _ in calls)
    return 100.0 * least / sum(dev for _, dev in calls)
