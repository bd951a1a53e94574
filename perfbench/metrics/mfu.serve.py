"""The traced window's model FLOPs (the reference's count of one batch's
matrix products and convolutions, times the batches) over its wall seconds
over the card's dense bf16 peak, %."""


def read(run):
    if run.trace is None or not run.flops_per_request or not run.peak_flops:
        return None
    return 100.0 * run.flops_per_request * run.traced_requests / run.trace["window_s"] / run.peak_flops
