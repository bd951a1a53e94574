"""Each kernel site's operations and bytes, from the shapes of one call.

A call's shapes are those that the reference's plain composition of the site
records (``perfbench/reference/plain.py::RECORD``), which are the shapes the
program's kernel is called with. Operations count the products at 2 a
multiply-add; bytes count each input read once and each output written once,
whatever the kernel reads again, at the served dtype's ``itemsize``, and only
what the inputs need: the query rows of a window's last strip that the caller
cuts are neither read nor written, and masked memory keys are not attended.
The least time of a call is the larger of its operations over the peak rate
and its bytes over the peak bandwidth.
"""

from __future__ import annotations


def window_attention(b, hp, wp, ws, nh, hd, q_pool, q_lq, itemsize):
    """Attention inside each ws x ws window of a [b, hp, wp, 3·nh·hd] qkv map,
    q 2x2-max-pooled with ``q_pool``; the last strip's windows keep ``q_lq``
    query rows when it is not 0. Returns (operations, bytes)."""
    nwh, nww = hp // ws, wp // ws
    lk = ws * ws
    lq = (ws // 2 if q_pool else ws) ** 2
    queries = b * nww * ((nwh - 1) * lq + (q_lq or lq))  # query tokens of every window
    ops = 4 * nh * hd * queries * lk
    q_read = queries * (4 if q_pool else 1)  # a pooled query reads its 2x2 input tokens
    bytes_ = itemsize * nh * hd * (2 * b * hp * wp + q_read + queries)
    return ops, bytes_


def flash_attention(b, h, lq, lk, d, itemsize):
    """softmax(q·kᵀ)·v of [b, h, lq, d] queries over ``lk`` attended keys.
    Returns (operations, bytes)."""
    ops = 4 * b * h * lq * lk * d
    bytes_ = itemsize * b * h * d * (2 * lq + 2 * lk)
    return ops, bytes_


SITES = {"window_attention": window_attention, "flash_attention": flash_attention}


def least_seconds(site: str, calls: list, peak_flops: float, peak_bytes_per_s: float) -> float:
    """The least time of ``site``'s calls among ``calls`` (``RECORD`` entries)."""
    total = 0.0
    for name, shape in calls:
        if name == site:
            ops, bytes_ = SITES[site](**shape)
            total += max(ops / peak_flops, bytes_ / peak_bytes_per_s)
    return total
