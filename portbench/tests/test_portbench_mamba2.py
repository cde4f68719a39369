"""The reference's Mamba-2 pieces (``portbench/reference/model.py``) against
the recurrence they compute, position by position, in float64 at tiny
sizes.

Tolerances: float64 on both sides, which differ only in the order of
their sums and in taking ``e^{A_t - A_s}`` as one exponential where the
recurrence multiplies ``e^{a}`` step by step: about 1e-15 relative an
operation over a few dozen terms.  ``rtol`` 1e-10 leaves five orders of
room for that, and a slip in the algebra (a wrong mask, a state passed
twice or not at all) reads 1e-2 or more.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from portbench.reference import model
from portbench.reference.model import Mamba2Dims

TOL = dict(rtol=1e-10, atol=1e-12)


def sequential_ssd(x, a, b, c):
    """h_t = e^{a_t} h_{t-1} + x_t b_t^T and y_t = h_t c_t, one position
    at a time: one ``bhpn,bhn->bhp`` read-out a position."""
    bsz, s, heads, head_p = x.shape
    per = heads // b.shape[2]
    bh, ch = (t.repeat_interleave(per, dim=2) for t in (b, c))
    h = x.new_zeros(bsz, heads, head_p, b.shape[3])
    ys = []
    for t in range(s):
        h = (torch.exp(a[:, t])[..., None, None] * h
             + x[:, t, :, :, None] * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    return torch.stack(ys, dim=1)


def inputs(bsz, s, heads, head_p, groups, state, seed=0):
    g = torch.Generator().manual_seed(seed)
    kw = dict(generator=g, dtype=torch.float64)
    x = torch.randn(bsz, s, heads, head_p, **kw)
    a = -torch.rand(bsz, s, heads, **kw) * 2     # log-decays in (-2, 0]
    b = torch.randn(bsz, s, groups, state, **kw)
    c = torch.randn(bsz, s, groups, state, **kw)
    return [t.requires_grad_() for t in (x, a, b, c)]


@pytest.mark.parametrize("s, chunk, groups", [
    (12, 4, 2),      # three whole chunks, two groups of two heads
    (11, 4, 4),      # a shorter last chunk, a group a head
    (9, 16, 1)])     # one chunk: the quadratic form alone
def test_ssd_is_the_recurrence(s, chunk, groups):
    x, a, b, c = inputs(2, s, 4, 3, groups, 5, seed=s)
    y = model.ssd(x, a, b, c, chunk)
    want = sequential_ssd(x, a, b, c)
    torch.testing.assert_close(y, want, **TOL)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    got = torch.autograd.grad((y * w).sum(), (x, a, b, c))
    ref = torch.autograd.grad((want * w).sum(), (x, a, b, c))
    for name, g1, g2 in zip("xabc", got, ref):
        torch.testing.assert_close(g1, g2, **TOL, msg=name)


def test_ssd_steep_decay_gives_no_nan():
    x, a, b, c = inputs(1, 8, 2, 3, 1, 4)
    steep = (a.detach() * 400).requires_grad_()
    y = model.ssd(x, steep, b, c, 4)
    grads = torch.autograd.grad(y.sum(), (x, steep, b, c))
    assert all(torch.isfinite(g).all() for g in (y,) + grads)


def test_gated_rmsnorm_by_hand():
    y = [0.5, -1.0, 2.0, 0.25, 1.5, -0.75]
    z = [1.0, -0.5, 0.3, 2.0, -1.2, 0.7]
    scale = [1.0, 2.0, 0.5, 1.5, -1.0, 3.0]
    eps, size = 1e-5, 2
    want = []
    for lo in range(0, len(y), size):
        g = [y[i] * z[i] / (1 + math.exp(-z[i]))
             for i in range(lo, lo + size)]
        r = 1 / math.sqrt(sum(v * v for v in g) / size + eps)
        want += [v * r * scale[lo + i] for i, v in enumerate(g)]
    t = lambda v: torch.tensor([v], dtype=torch.float64)    # noqa: E731
    got = model.gated_rmsnorm(t(y), t(z), t(scale)[0], eps, size)
    torch.testing.assert_close(got, t(want), **TOL)
    # the whole width as one group is a plain RMSNorm of y * silu(z)
    whole = model.gated_rmsnorm(t(y), t(z), t(scale)[0], eps, len(y))
    gz = t(y) * F.silu(t(z))
    torch.testing.assert_close(whole, model.rmsnorm(gz, t(scale)[0], eps),
                               **TOL)


DIMS = Mamba2Dims(heads=4, head_p=3, state=5, groups=2, conv_width=4,
                  chunk=4)
D_MODEL = 8


def mixer_params(dims, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape, std=0.5: (torch.randn(                # noqa: E731
        *shape, generator=g, dtype=torch.float64) * std).requires_grad_()
    conv = dims.inner + 2 * dims.groups * dims.state
    return {"m.in_proj.w": r(d, dims.inner + conv + dims.heads),
            "m.conv_w": r(dims.conv_width, conv),
            "m.conv_b": r(conv, std=0.1),
            "m.dt_bias": r(dims.heads),
            "m.a_log": r(dims.heads),
            "m.d_skip": r(dims.heads),
            "m.norm.scale": r(dims.inner, std=1.0),
            "m.out_proj.w": r(dims.inner, d)}


def recurrent_mixer(p, x, dims, eps):
    """The mixer one position at a time, as a decoder steps it: the
    convolution over the last ``conv_width`` inputs, the state updated
    and read, the gated norm of each group."""
    bsz, s, _ = x.shape
    gn, per = dims.groups * dims.state, dims.heads // dims.groups
    zxbcdt = x @ p["m.in_proj.w"]
    z, xbc, dt = zxbcdt.split([dims.inner, dims.inner + 2 * gn, dims.heads],
                              dim=-1)
    h = x.new_zeros(bsz, dims.heads, dims.head_p, dims.state)
    out = []
    for t in range(s):
        conv = p["m.conv_b"].clone()
        for i in range(dims.conv_width):
            src = t - dims.conv_width + 1 + i
            if src >= 0:
                conv = conv + p["m.conv_w"][i] * xbc[:, src]
        xs, bt, ct = F.silu(conv).split([dims.inner, gn, gn], dim=-1)
        step = F.softplus(dt[:, t] + p["m.dt_bias"])               # (B,H)
        xh = xs.reshape(bsz, dims.heads, dims.head_p)
        bh = bt.reshape(bsz, dims.groups, dims.state).repeat_interleave(
            per, dim=1)
        ch = ct.reshape(bsz, dims.groups, dims.state).repeat_interleave(
            per, dim=1)
        decay = torch.exp(-torch.exp(p["m.a_log"]) * step)
        h = (decay[..., None, None] * h
             + (xh * step[..., None])[..., None] * bh[:, :, None, :])
        y = torch.einsum("bhpn,bhn->bhp", h, ch) \
            + p["m.d_skip"][:, None] * xh
        gated = (y.reshape(bsz, dims.inner) * F.silu(z[:, t])).reshape(
            bsz, dims.groups, -1)
        normed = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True)
                                     + eps)
        out.append(normed.reshape(bsz, dims.inner) * p["m.norm.scale"])
    return torch.stack(out, dim=1) @ p["m.out_proj.w"]


def test_mamba2_mixer_is_its_recurrence():
    p = mixer_params(DIMS, D_MODEL)
    x = torch.randn(2, 11, D_MODEL, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    got = model.mamba2_mixer(p, "m.", x, DIMS, 1e-5)
    want = recurrent_mixer(p, x, DIMS, 1e-5)
    torch.testing.assert_close(got, want, **TOL)
    leaves = list(p.values())
    for g1, g2 in zip(torch.autograd.grad(got.square().sum(), leaves),
                      torch.autograd.grad(want.square().sum(), leaves)):
        torch.testing.assert_close(g1, g2, **TOL)


def test_every_product_of_the_mixer_goes_through_mm():
    p = {k: v.detach().float() for k, v in mixer_params(DIMS,
                                                        D_MODEL).items()}
    x = torch.randn(1, 12, D_MODEL)
    calls = []

    def counting(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return torch.matmul(a, b)

    model.mamba2_mixer(p, "m.", x, DIMS, 1e-5, counting)
    # in_proj and out_proj, and four products in each of three chunks
    assert len(calls) == 2 + 4 * 3
    zero = model.mamba2_mixer(p, "m.", x, DIMS, 1e-5,
                              lambda a, b: torch.matmul(a, b) * 0)
    assert not zero.any()
    # the float8 control runs through it, forward and backward
    pf = {k: v.requires_grad_() for k, v in p.items()}
    y = model.mamba2_mixer(pf, "m.", x, DIMS, 1e-5, model.fp8_mm)
    grads = torch.autograd.grad(y.square().sum(), list(pf.values()))
    assert all(torch.isfinite(g).all() and g.any() for g in grads)
    exact = model.mamba2_mixer(p, "m.", x, DIMS, 1e-5)
    assert not torch.equal(y.detach(), exact)


class Hybrid(model.Decoder):
    """Two layers: attention, then a Mamba-2 mixer named as a layer's
    third element."""
    seen = None

    def layers(self):
        return [("l0.", "mlp"), ("l1.", "mlp", "mamba")]

    def attention(self, p, pre, x):
        self.seen.append(("attention", pre))
        return x * p[pre + "attn.gain"]

    def mamba(self, p, pre, x):
        self.seen.append(("mamba", pre))
        return model.mamba2_mixer(p, pre + "ssm.", x, DIMS, self.eps,
                                  self.mm)


def test_a_layer_names_its_mixer():
    c = {"reference": {"norm_eps": 1e-6}, "rope_theta": 10000,
         "tie_word_embeddings": True}
    g = torch.Generator().manual_seed(0)
    p = {"embed.table": torch.randn(16, D_MODEL, generator=g),
         "final_norm.scale": torch.ones(D_MODEL),
         "l0.attn.gain": torch.tensor(0.5)}
    for pre in ("l0.", "l1."):
        p[pre + "ln1.scale"] = torch.ones(D_MODEL)
        p[pre + "ln2.scale"] = torch.ones(D_MODEL)
        for n, shape in (("gate", (D_MODEL, 12)), ("up", (D_MODEL, 12)),
                         ("down", (12, D_MODEL))):
            p[pre + f"mlp.{n}.w"] = torch.randn(*shape, generator=g) * 0.3
    p.update({"l1.ssm." + k[2:]: v.detach().float()
              for k, v in mixer_params(DIMS, D_MODEL).items()})
    p = {k: v.requires_grad_() for k, v in p.items()}
    net = Hybrid(c)
    net.seen = []
    tokens = torch.randint(0, 16, (2, 10), generator=g)
    loss = net.loss(p, tokens, tokens.roll(-1, dims=1))
    assert net.seen == [("attention", "l0."), ("mamba", "l1.")]
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    assert torch.isfinite(loss)
    assert all(grads[k].any() for k in p if k.startswith("l1.ssm."))
