"""DeepSeek-V2(-Lite) as the benchmark runs it (arXiv:2405.04434).

Multi-head latent attention: a ``kv_lora_rank`` latent of each position,
RMS-normed, decompressed per head into the ``qk_nope`` key part and the
value; a ``qk_rope`` key part shared by the heads; the queries projected
whole (no ``q_lora``); softmax scale ``(qk_nope + qk_rope) ** -0.5``.
The first ``first_k_dense_replace`` layers have a dense SwiGLU MLP, the
rest a mixture of experts: a softmax router over ``n_routed_experts``,
the ``num_experts_per_tok`` largest probabilities as the gates (not
renormalised), each routed token through its experts' SwiGLU, plus the
``n_shared_experts`` shared experts as one SwiGLU of their summed width.
The reference computes each expert on the tokens routed to it.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import layout
from portbench.reference.model import (Decoder, attention, linear, rmsnorm,
                                       rope, swiglu)

# The CPU tests' stand-in sizes (portbench/tests/tinycells.py): every
# width shrunk, three layers (the dense one and two MoE).
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
            n_shared_experts=1, moe_intermediate_size=48,
            intermediate_size=192, vocab_size=256, num_hidden_layers=3)


def attention_dims(c: Dict):
    """(heads, kv heads, D_qk, D_v)."""
    h = c["num_attention_heads"]
    return (h, h, c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
            c["v_head_dim"])


def _attention_leaves(c: Dict) -> List[layout.Leaf]:
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rd = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    r, dv = c["kv_lora_rank"], c["v_head_dim"]
    return [layout.normal(("attn", "wq", "w"), (d, h * (nope + rd)), d),
            layout.normal(("attn", "w_dkv", "w"), (d, r + rd), d),
            layout.ones(("attn", "kv_norm", "scale"), (r,)),
            layout.normal(("attn", "w_uk"), (r, h, nope), r),
            layout.normal(("attn", "w_uv"), (r, h, dv), r),
            layout.normal(("attn", "wo", "w"), (h * dv, d), h * dv)]


def _moe_leaves(c: Dict) -> List[layout.Leaf]:
    d, e = c["hidden_size"], c["n_routed_experts"]
    f = c["moe_intermediate_size"]
    out = [layout.normal(("moe", "router", "w"), (d, e), d),
           layout.normal(("moe", "experts", "gate"), (e, d, f), d),
           layout.normal(("moe", "experts", "up"), (e, d, f), d),
           layout.normal(("moe", "experts", "down"), (e, f, d), f)]
    if c["n_shared_experts"]:
        out += layout.swiglu(("moe", "shared"), d,
                             c["n_shared_experts"] * f)
    return out


def leaves(c: Dict) -> List[layout.Leaf]:
    dense, n = c["first_k_dense_replace"], c["num_hidden_layers"]
    out = layout.top(c)
    if dense:
        out += layout.stack(layout.block(c, _attention_leaves(c),
                                         layout.swiglu(
                                             ("mlp",), c["hidden_size"],
                                             c["intermediate_size"])),
                            "dense_layers", dense)
    return out + layout.stack(layout.block(c, _attention_leaves(c),
                                           _moe_leaves(c)),
                              "layers", n - dense)


def active_params(c: Dict) -> int:
    """Parameters of a token's products: the attention projections, the
    dense MLPs, the router and the ``top_k`` routed plus the shared
    experts of each MoE layer, and the head."""
    d, n = c["hidden_size"], c["num_hidden_layers"]
    dense = c["first_k_dense_replace"]
    attn = sum(leaf.numel for leaf in _attention_leaves(c)
               if leaf.init == "normal")
    moe = (d * c["n_routed_experts"]
           + (c["num_experts_per_tok"] + c["n_shared_experts"])
           * 3 * d * c["moe_intermediate_size"])
    return (n * attn + dense * 3 * d * c["intermediate_size"]
            + (n - dense) * moe + d * c["vocab_size"])


class Model(Decoder):
    def layers(self):
        c = self.c
        dense = c["first_k_dense_replace"]
        return ([(f"dense_layers.{i}.", "mlp") for i in range(dense)]
                + [(f"layers.{i}.", "moe")
                   for i in range(c["num_hidden_layers"] - dense)])

    def attention(self, p, pre, x):
        c, mm = self.c, self.mm
        b, s, _ = x.shape
        h = c["num_attention_heads"]
        nope, rd = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        r, dv = c["kv_lora_rank"], c["v_head_dim"]
        q = linear(x, p[pre + "attn.wq.w"], mm).view(b, s, h, nope + rd)
        q_nope, q_rope = q.split([nope, rd], dim=-1)
        latent, k_rope = linear(x, p[pre + "attn.w_dkv.w"], mm).split(
            [r, rd], dim=-1)
        latent = rmsnorm(latent, p[pre + "attn.kv_norm.scale"], self.eps)
        k_nope = linear(latent, p[pre + "attn.w_uk"].reshape(r, h * nope),
                        mm).view(b, s, h, nope)
        v = linear(latent, p[pre + "attn.w_uv"].reshape(r, h * dv),
                   mm).view(b, s, h, dv)
        k_rope = rope(k_rope, self.theta)[:, :, None, :].expand(b, s, h, rd)
        q = torch.cat([q_nope, rope(q_rope, self.theta)], dim=-1)
        k = torch.cat([k_nope, k_rope], dim=-1)
        o = attention(q, k, v, (nope + rd) ** -0.5, mm)
        return linear(o.reshape(b, s, h * dv), p[pre + "attn.wo.w"], mm)

    def feed_forward(self, p, pre, x, kind):
        if kind != "moe":
            return super().feed_forward(p, pre, x, kind)
        c, mm = self.c, self.mm
        xt = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(mm(xt, p[pre + "moe.router.w"]), dim=-1)
        gates, chosen = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
        out = torch.zeros_like(xt)
        gate_w, up_w, down_w = (p[pre + "moe.experts." + n]
                                for n in ("gate", "up", "down"))
        for e in range(c["n_routed_experts"]):
            tok, slot = (chosen == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            y = swiglu(xt[tok], gate_w[e], up_w[e], down_w[e], mm)
            out = out.index_add(0, tok, y * gates[tok, slot, None])
        out = out.view_as(x)
        if c["n_shared_experts"]:
            out = out + swiglu(x, *(p[pre + f"moe.shared.{n}.w"]
                                    for n in ("gate", "up", "down")), mm)
        return out
