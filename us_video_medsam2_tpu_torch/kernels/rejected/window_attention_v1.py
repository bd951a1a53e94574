"""The attention half of a Hiera block in one call — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/rejected/window_attention_v1.py``
(``window_attention``, bodies ``_run`` / ``_kernel``). Unwired, as in the JAX
package: no model calls it. Over a spatial map already padded to whole
windows, x [B, Hp, Wp, C]: optional LayerNorm in f32 rounded to x's dtype
(pad tokens included, so a zero pad token becomes ``beta``); per head, q, k
and v as products with f32 accumulation plus the f32 bias, rounded; q
optionally 2x2 max-pooled inside the window; f32 logits times Dh^-½ and f32
softmax, P normalised before its rounding; o = P·v rounded; and
out = Σ_h o_h·wo_h + bo summed over heads in f32 and rounded once. Output
[B, Hp/ws·wso, Wp/ws·wso, Co]. Pad tokens are attended unmasked.

On the H100 it is bound by operations (the q/k/v projections, the attention
products and the output projection). The CUDA kernels
(``csrc/window_attention_v1.cu``) cut the TPU kernel's one pass in two, since
one window's f32 [wso², Co] accumulator can exceed a block's shared memory:
one block per (window, head, batch) normalises, projects, pools and attends,
writing each head's o (bf16, where the reference rounds it) into a scratch
map; a second kernel computes o·wo + bo over all heads in f32. Dh is 96
only, as for the other window kernels; ws up to 16 (256 tokens a window).

The gradient is that of ``_xla_ref`` (the JAX custom_vjp's XLA recompute):
the plain version's, recomputed in the backward pass, with no kernel launch.
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_HD = (96,)
MAX_WS = 16
C_CHUNK = 48  # the kernel streams C in chunks of 48
CO_TILE = 96  # the output projection's column tile


def _ln(x, gamma, beta, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(x.dtype)


def window_attention_v1_plain(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo,
                              ws: int, q_pool: bool, ln_inside: bool, eps: float):
    """Plain PyTorch version (the JAX ``_xla_ref``)."""
    b, hp, wp, c = x.shape
    nh, _, dh = wq.shape
    co = wo.shape[2]
    dt = x.dtype
    y = _ln(x, gamma, beta, eps) if ln_inside else x
    nwh, nww = hp // ws, wp // ws
    yw = y.reshape(b, nwh, ws, nww, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nwh * nww, ws * ws, c)

    def project(w, bias):
        return (torch.einsum("bnc,hcd->bhnd", yw.float(), w.to(dt).float())
                + bias.float()[None, :, None, :]).to(dt)

    q, k, v = project(wq, bq), project(wk, bk), project(wv, bv)
    wso = ws
    if q_pool:
        wso = ws // 2
        q = q.reshape(-1, nh, wso, 2, wso, 2, dh).amax(dim=(3, 5)).reshape(-1, nh, wso * wso, dh)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh**-0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v.float()).to(dt)
    out = torch.einsum("bhqd,hdc->bqc", o.float(), wo.to(dt).float()) + bo.float()
    out = out.to(dt).reshape(b, nwh, nww, wso, wso, co).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, nwh * wso, nww * wso, co)


def window_attention_v1(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo,
                        ws: int, q_pool: bool, ln_inside: bool, eps: float):
    """[B, Hp, Wp, C] -> [B, Hp/ws·wso, Wp/ws·wso, Co]. CPU tensors take the
    plain version; a CUDA tensor launches the kernels (bf16 x; the weights
    are cast to x's dtype and the norm and bias vectors to f32, as the TPU
    kernel casts them) or raises. The gradient is the plain version's,
    recomputed in the backward pass."""
    args = (x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo, ws, q_pool, ln_inside, eps)
    if x.is_cpu:
        return window_attention_v1_plain(*args)
    return _lib.with_plain_grad(_kernel, window_attention_v1_plain, *args)


def _kernel(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo, ws, q_pool, ln_inside, eps):
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("window_attention_v1 kernel takes contiguous, 16-byte aligned bf16 CUDA x")
    b, hp, wp, c = x.shape
    nh, _, dh = wq.shape
    co = wo.shape[2]
    if dh not in SUPPORTED_HD or c % C_CHUNK or co % CO_TILE:
        raise ValueError(f"window_attention_v1 kernel: Dh={dh} not in {SUPPORTED_HD}, or C={c} % {C_CHUNK}, "
                         f"or Co={co} % {CO_TILE}")
    if not 0 < ws <= MAX_WS or hp % ws or wp % ws or (q_pool and ws % 2):
        raise ValueError(f"window_attention_v1 kernel: ws={ws} must divide {hp}x{wp}, <= {MAX_WS}")

    def cast(t, shape, dtype):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"window_attention_v1 kernel: a parameter of shape {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {x.device}")
        return t.detach().to(dtype).contiguous()

    f32, dt = torch.float32, x.dtype
    params = [cast(gamma, (c,), f32), cast(beta, (c,), f32),
              *(cast(w, (nh, c, dh), dt) for w in (wq, wk, wv)),
              *(cast(bias, (nh, dh), f32) for bias in (bq, bk, bv)),
              cast(wo, (nh, dh, co), dt), cast(bo, (co,), f32)]
    wso = ws // 2 if q_pool else ws
    hpo, wpo = hp // ws * wso, wp // ws * wso
    o = torch.empty((b, hpo, wpo, nh * dh), dtype=dt, device=x.device)
    out = torch.empty((b, hpo, wpo, co), dtype=dt, device=x.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_window_attention_v1_bf16", [_lib.P] * 13 + [_lib.I] * 10 + [_lib.F, _lib.F, _lib.P])
    rc = _fn(x.data_ptr(), *(p.data_ptr() for p in params), o.data_ptr(), out.data_ptr(),
             b, hp, wp, c, nh, dh, co, ws, int(q_pool), int(ln_inside), float(eps), float(dh**-0.5),
             _lib.stream_ptr(x))
    _lib.check(rc, "window_attention_v1")
    window_attention_v1.launches += 1
    return out


window_attention_v1.launches = 0
_fn = None  # usm_window_attention_v1_bf16, bound at the first launch


def split_qkv_params(wqkv, bqkv, wproj, n_heads: int):
    """[C, 3·Do], [3·Do], [Do, Do] (the Dense layout, inputs first) ->
    per-head wq/wk/wv [H, C, Dh], bq/bk/bv [H, Dh], wo [H, Dh, Do]. A copy of
    the JAX package's ``split_qkv_params``; the port's Linear weights are
    [out, in], so pass ``qkv.weight.T`` and ``proj.weight.T``."""
    c, three_do = wqkv.shape
    do = three_do // 3
    dh = do // n_heads
    w = wqkv.reshape(c, 3, n_heads, dh)
    bqkv_ = bqkv.reshape(3, n_heads, dh)
    wq = w[:, 0].permute(1, 0, 2)
    wk = w[:, 1].permute(1, 0, 2)
    wv = w[:, 2].permute(1, 0, 2)
    wo = wproj.reshape(n_heads, dh, wproj.shape[1])
    return wq, wk, wv, bqkv_[0], bqkv_[1], bqkv_[2], wo
