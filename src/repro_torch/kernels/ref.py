"""Plain PyTorch versions of the ported kernels (the allclose reference).

Each hand-written Hopper kernel in this package has its plain version
here.  The wrappers take it for tensors that lie on the CPU, the CPU
tests hold the JAX package's oracles against it, and ``chip_smoke.py``
holds each kernel against it on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NO_WINDOW = 1 << 30     # an attention window that masks nothing
NEG_LOGIT = -1e30       # the logit of a masked key


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, the precision of every plain version's math — or in f64
    when it is f64 already, so that an f64 model is an exact evaluation
    of the same function (the tests' yardstick for f32 rounding)."""
    return x if x.dtype == torch.float64 else x.float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` whose rows do not depend on how many rows there are.

    PyTorch's CPU GEMM takes another path for a one-row product than for
    two or more, and the two round differently (up to 2.5e-4 apart at
    2560x6912), while every product with two or more rows agrees bit for
    bit.  A decode lane must compute the same bits alone (``generate``
    at batch 1) as beside other lanes (the engine's fixed-width pass), so
    on the CPU a one-row product is padded to two rows.  Where ``w`` is
    batched (an MoE layer's experts, ``(E, K, N)``), each batch entry's
    product is padded where it has one row."""
    if x.device.type == "cpu" and x.ndim >= 2:
        if w.ndim > 2 and x.shape[-2] == 1:
            return (torch.cat([x, x], dim=-2) @ w)[..., :1, :]
        if x.numel() == x.shape[-1]:
            lead = x.shape[:-1]
            x2 = x.reshape(1, x.shape[-1])
            y = (torch.cat([x2, x2]) @ w)[:1]
            return y.reshape(*lead, w.shape[-1])
    return x @ w


def matmul_leakyrelu(a: torch.Tensor, b: torch.Tensor,
                     negative_slope: float = 0.01) -> torch.Tensor:
    """Fused GEMM + LeakyReLU epilogue: the product in f32, the epilogue
    on the f32 sum, one rounding to a's type (paper Table 2:
    mmLeakyReLu)."""
    af = wide(a)
    y = matmul(af, b.to(af.dtype))
    return torch.where(y >= 0, y, negative_slope * y).to(a.dtype)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch matrix multiplication (B, M, K) x (B, K, N) in f32, one
    rounding to a's type (paper Table 2: bmm)."""
    af = wide(a)
    return torch.matmul(af, b.to(af.dtype)).to(a.dtype)


def fused_ff(x: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor) -> torch.Tensor:
    """Fused LLaMA-style feed-forward front half: silu(x@Wg) * (x@Wu),
    in f32, cast to x's type (paper Table 2: fused_ff)."""
    xf = wide(x)
    g = matmul(xf, w_gate.to(xf.dtype))
    u = matmul(xf, w_up.to(xf.dtype))
    return (F.silu(g) * u).to(x.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax over the last axis, in f32 (max-subtract,
    exp, normalize), cast to x's type once (paper Table 2: softmax)."""
    xf = wide(x)
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square layer normalization over the last axis, in f32,
    cast to x's type (paper Table 2: rmsnorm)."""
    xf = wide(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(xf.dtype)).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = NO_WINDOW,
                    q_offset: int = 0,
                    scale: float = None) -> torch.Tensor:
    """Attention over the whole key axis in f32, cast to q's type (paper
    Table 2: flash-attention; the math of the reference's
    ``nn.attention.chunked_attention``).

    q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with H % KH == 0 (query head h
    reads KV head h // (H // KH)).  Query row i sits at position
    ``q_offset + i`` and may see key j when ``j > q_pos - window`` and,
    if causal, ``j <= q_pos``; a masked logit is -1e30, and the row sum l
    is floored at 1e-30.  q is scaled before the product.  A row that sees
    no key gets the mean of v, as the reference's recurrence gives it."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KH
    if scale is None:
        scale = D ** -0.5
    qf = wide(q).reshape(B, KH, G * Sq, D) * scale
    logits = torch.matmul(qf, k.to(qf.dtype).transpose(-1, -2))
    logits = logits.reshape(B, KH, G, Sq, Sk)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = k_pos > q_pos - window
    if causal:
        mask = mask & (k_pos <= q_pos)
    logits = logits.masked_fill(~mask, NEG_LOGIT)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    ell = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.reshape(B, KH, G * Sq, Sk), v.to(qf.dtype))
    o = o.reshape(B, KH, G, Sq, Dv) / ell.clamp_min(1e-30)
    return o.reshape(B, H, Sq, Dv).to(q.dtype)


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Mamba-2 SSD (state-space duality) scan in its chunked dual form, in
    f32, cast to x's type once (the function of the reference's
    sequential-scan oracle ``repro/kernels/ref.py::ssd_chunk`` and of the
    TPU kernel ``repro/kernels/ssd.py::_kernel``).

    x: (B, S, H, P) inputs; a: (B, S, H) log-decay (<= 0); b, c:
    (B, S, G, N) input/output projections, group g serving heads
    g*H/G .. (g+1)*H/G - 1.  Returns y: (B, S, H, P) with
    ``y[t] = sum_{s<=t} e^{A_t - A_s} (c_t . b_s) x_s``, A the running
    sum of a.  The sequence is cut into chunks of ``chunk`` positions
    (any S: the tail is padded with a = 0 and x = 0, then trimmed); each
    chunk's own part is one masked product, ``(C B^T * L) X`` with
    ``L[t, s] = e^{seg_t - seg_s} [t >= s]`` and ``seg`` the chunk's
    running sum of a, and the (P, N) state carries the earlier chunks in
    through ``e^{seg_t} C state^T``, updated as ``e^{seg_end} state +
    (X e^{seg_end - seg})^T B`` in a loop over the chunks.  The exponent
    of L is masked before ``exp`` (never after), so a steep decay gives
    no inf and its gradient no NaN."""
    xf, xc, bc, cc, seg, expo = _ssd_chunks(x, a, b, c, chunk)
    scores = torch.matmul(cc, bc.transpose(-1, -2))        # (B,G,1,nc,L,L)
    y = torch.matmul(scores * torch.exp(expo), xc)         # (B,G,R,nc,L,P)
    # e^{seg_end - seg_s}: the last row of expo
    local = torch.matmul((xc * torch.exp(expo[..., -1, :])[..., None])
                         .transpose(-1, -2), bc)           # (B,G,R,nc,P,N)
    decay = torch.exp(seg[..., -1])                        # (B,G,R,nc)
    B, G, R, nc, L, P = xc.shape
    state = xf.new_zeros(B, G, R, P, bc.shape[-1])
    before = []
    # one unbind per tensor: its backward stacks the chunks' gradients
    # once, where indexing chunk by chunk would add a zero-filled
    # full-size gradient per chunk
    for d, loc in zip(decay.unbind(-1), local.unbind(3)):
        before.append(state)
        state = d[..., None, None] * state + loc
    state_in = torch.stack(before, dim=3)                  # (B,G,R,nc,P,N)
    y = y + torch.exp(seg)[..., None] * torch.matmul(
        cc, state_in.transpose(-1, -2))
    return _ssd_unchunk(y, x)


def _ssd_chunks(x, a, b, c, chunk):
    """:func:`ssd_chunk`'s operands in f32 cut into chunks (the tail
    padded with a = 0 and x = b = c = 0): xf, and x, b, c as (B, G, R,
    nc, L, .) (b and c shared by a group: R = 1), the chunks' running sums
    seg of a (B, G, R, nc, L), and expo[t, s] = a_{s+1} + ... + a_t for
    t >= s, -inf above the diagonal."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    R, L = H // G, chunk
    nc = -(-S // L)
    pad = nc * L - S
    xf = wide(x)
    af, bf, cf = a.to(xf.dtype), b.to(xf.dtype), c.to(xf.dtype)
    if pad:
        xf, bf, cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, bf, cf))
        af = F.pad(af, (0, 0, 0, pad))
    # chunked layouts: (B, G, R, nc, L, ...), b and c shared by a group
    xc = xf.reshape(B, nc, L, G, R, P).permute(0, 3, 4, 1, 2, 5)
    ac = af.reshape(B, nc, L, G, R).permute(0, 3, 4, 1, 2)
    bc = bf.reshape(B, nc, L, G, N).permute(0, 3, 1, 2, 4)[:, :, None]
    cc = cf.reshape(B, nc, L, G, N).permute(0, 3, 1, 2, 4)[:, :, None]
    seg = torch.cumsum(ac, -1)                             # (B,G,R,nc,L)
    # expo[t, s] = seg_t - seg_s = a_{s+1} + ... + a_t, summed as it
    # stands: the difference of two running sums would lose their low
    # bits (about 1e-5 relative at mamba2's decay)
    keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    after = keep.tril(-1)                                  # k > s
    expo = torch.cumsum(ac[..., :, None].expand(*ac.shape, L).masked_fill(
        ~after, 0), -2).masked_fill(~keep, float("-inf"))
    return xf, xc, bc, cc, seg, expo


def _ssd_unchunk(y, x):
    """(B, G, R, nc, L, P) chunked outputs -> (B, S, H, P) in x's type."""
    B, S, H, P = x.shape
    nc, L = y.shape[3], y.shape[4]
    return y.permute(0, 3, 4, 1, 2, 5).reshape(B, nc * L, H, P)[:, :S] \
        .to(x.dtype)


def _bf16_pair(v: torch.Tensor) -> torch.Tensor:
    """v as the sum of a bf16 pair, hi = bf16(v) and lo = bf16(v - hi), in
    f32 (the sum is exact there)."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def ssd_chunk_parallel(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, chunk: int = 64,
                       segments: int = 1) -> torch.Tensor:
    """:func:`ssd_chunk` computed as ``csrc/ssd.cu`` computes it, for the
    tests: the chunks cut into ``segments`` segments; (A) each segment's
    end state from 0 and its decay, (B) the pass across segments giving
    each segment's incoming state, (C) each segment's outputs from its
    incoming state, chunk by chunk.  With bf16 operands it rounds where
    the wgmma route rounds: M = (C B^T) * L, the incoming state of every
    chunk and (X e^{seg_end - seg}) each enter their products as a bf16
    pair (:func:`_bf16_pair`); f32 operands are taken in f32, as the SIMT
    route takes them."""
    pair = _bf16_pair if x.dtype == torch.bfloat16 else (lambda v: v)
    xf, xc, bc, cc, seg, expo = _ssd_chunks(x, a, b, c, chunk)
    B, G, R, nc, L, P = xc.shape
    m = pair(torch.matmul(cc, bc.transpose(-1, -2)) * torch.exp(expo))
    y = torch.matmul(m, xc)
    wx = pair(xc * torch.exp(expo[..., -1, :])[..., None])
    local = torch.matmul(wx.transpose(-1, -2), bc)         # (B,G,R,nc,P,N)
    decay = torch.exp(seg[..., -1])                        # (B,G,R,nc)
    per = -(-nc // segments)
    zero = xf.new_zeros(B, G, R, P, bc.shape[-1])
    run, before = zero, []
    for k0 in range(0, nc, per):
        chunks = range(k0, min(nc, k0 + per))
        state, end, total = run, zero, 1.0
        for j in chunks:                                   # (C)
            before.append(state)
            state = decay[..., j, None, None] * state + local[:, :, :, j]
        for j in chunks:                                   # (A)
            end = decay[..., j, None, None] * end + local[:, :, :, j]
            total = total * decay[..., j, None, None]
        run = total * run + end                            # (B)
    state_in = pair(torch.stack(before, dim=3))            # (B,G,R,nc,P,N)
    y = y + torch.exp(seg)[..., None] * torch.matmul(
        cc, state_in.transpose(-1, -2))
    return _ssd_unchunk(y, x)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int = 64) -> torch.Tensor:
    """:func:`ssd_chunk` in the flat layout of the registry's kernel
    (``repro/kernels/ops.py::ssd``): x (BH, S, P); a (BH, S); b, c
    (BH, S, N), one head and one group per row."""
    return ssd_chunk(x[:, :, None], a[:, :, None], b[:, :, None],
                     c[:, :, None], chunk)[:, :, 0]
