"""The median, over the traced requests, of init_state + add_new_points_or_box
up to a synchronize: the benchmark's own span, host clock."""

import statistics


def read(run):
    return statistics.median(run.prompt_ms) if run.prompt_ms else None
