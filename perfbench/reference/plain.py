"""The plain compositions that stand in the reference for the port's kernels.

Each function is the port's plain version of a kernel (``kernels/*.py`` at
commit 40a6c6c: ``layer_norm_plain``, ``ln_mlp_residual_plain``,
``window_attention_plain``, ``flash_attention_plain``), copied here so that the reference imports nothing
of the port. Given float32 operands every product and every reduction runs in
float32. One departure, which does not change the function:
``flash_attention`` attends over the valid keys alone where every row has as
many (masked keys contribute exact zeros), which is the work the inputs need.
The fused configuration's kernels and the training step's are not copied: no
cell runs them.

``RECORD``, when a list, receives one entry a call of the window-attention and
flash sites (``perfbench/work`` computes their operations and bytes from it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
RECORD: list | None = None


def layer_norm_plain(x, weight, bias, eps: float = 1e-6):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    meansq = xf.square().mean(-1, keepdim=True)
    var = torch.clamp(meansq - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


layer_norm = layer_norm_plain


def ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(x.dtype)
    h = (F.linear(y.float(), w1.to(x.dtype).float()) + b1.float()).to(x.dtype)
    h = F.gelu(h.float(), approximate="none").to(x.dtype)
    o = (F.linear(h.float(), w2.to(x.dtype).float()) + b2.float()).to(x.dtype)
    return x + o


def _cut_query_rows(hp: int, ws: int, q_pool: bool, real_h: int | None) -> int:
    """Real query rows of each last-strip window of a bottom-padded map (0: no cut)."""
    rr = 0
    if real_h is not None and real_h < hp:
        rr = real_h - (hp // ws - 1) * ws
        if rr <= 0 or rr >= ws or (q_pool and rr % 2):
            rr = 0
    wso = ws // 2 if q_pool else ws
    return (rr // 2 if q_pool else rr) * wso


def window_attention(qkv, ws: int, nh: int, q_pool: bool, real_h: int | None = None):
    """[B, Hp, Wp, 3·nh·hd] -> [B, Hpo, Wpo, nh·hd]: attention inside each
    ws x ws window (q 2x2-max-pooled with ``q_pool``); the last strip's rows
    past ``real_h`` are zero."""
    b, hp, wp, c = qkv.shape
    hd = c // (3 * nh)
    nwh, nww = hp // ws, wp // ws
    lk = ws * ws
    wso = ws // 2 if q_pool else ws
    lq = wso * wso
    q_lq = _cut_query_rows(hp, ws, q_pool, real_h)
    if RECORD is not None:
        RECORD.append(("window_attention", dict(b=b, hp=hp, wp=wp, ws=ws, nh=nh, hd=hd, q_pool=q_pool,
                                                q_lq=q_lq, itemsize=2)))
    t = qkv.reshape(b, nwh, ws, nww, ws, 3, nh, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    t = t.reshape(3, b * nwh * nww * nh, lk, hd)
    q, k, v = t[0], t[1], t[2]
    n = q.shape[0]
    if q_pool:
        q = q.reshape(n, wso, 2, wso, 2, hd).amax(dim=(2, 4)).reshape(n, lq, hd)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (hd**-0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    o = o.reshape(b, nwh, nww, nh, wso, wso, hd).permute(0, 1, 4, 2, 5, 3, 6)
    o = o.reshape(b, nwh * wso, nww * wso, nh * hd)
    if q_lq:
        o = o.clone()
        o[:, (nwh - 1) * wso + q_lq // wso:] = 0
    return o


def flash_attention_plain(q, k, v, key_mask=None):
    """softmax(q·kᵀ/√D, masked keys at -inf)·v over [B, H, L, D]."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention(q, k, v, key_mask=None):
    """``flash_attention_plain`` over the valid keys alone where every row
    has as many of them and at least one."""
    b, h, lq, d = q.shape
    if key_mask is not None:
        counts = key_mask.sum(1)
        n = int(counts[0])
        if n > 0 and bool((counts == n).all()):
            idx = key_mask.nonzero()[:, 1].reshape(b, 1, n, 1).expand(b, h, n, d)
            k, v, key_mask = k.gather(2, idx), v.gather(2, idx), None
    if RECORD is not None:
        lk = k.shape[2] if key_mask is None else int(key_mask.sum(1).max())
        RECORD.append(("flash_attention", dict(b=b, h=h, lq=lq, lk=lk, d=d, itemsize=2)))
    return flash_attention_plain(q, k, v, key_mask)
