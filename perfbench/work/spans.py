"""The program's own spans (``us_video_medsam2_tpu_torch/utils/profiling.py``),
read after a traced window: each span's device time, taken on the card inside
every CUDA graph replay, over a count the program's registry kept beside it.
The registry holds only what ran while the profiler recorded, every attempt
of the traced window included, so a ratio of its own numbers stays right when
the harness traces the window again. A program without spans, or without
the span named, gives None."""


def totals(run):
    """``span_totals()`` of a traced run, or None."""
    if run.trace is None:
        return None
    try:
        from us_video_medsam2_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else None


def device_ms_per(run, name: str, over: str, key: str):
    """Span ``name``'s device ms over span ``over``'s ``key`` (``rows`` or ``count``)."""
    t = totals(run)
    if not t or name not in t or over not in t or not t[over][key]:
        return None
    return t[name]["device_ms"] / t[over][key]
