"""StableLM-3B-4E1T as the benchmark runs it: pre-norm decoder layers of
multi-head attention (RoPE over the whole head, softmax scale
``head_dim ** -0.5``) and a SwiGLU MLP."""

from __future__ import annotations

from typing import Dict, List

from portbench import layout
from portbench.reference.model import Decoder, attention, linear, rope

# The CPU tests' stand-in sizes (portbench/tests/tinycells.py).
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            head_dim=16, intermediate_size=128, vocab_size=256,
            num_hidden_layers=2)


def attention_dims(c: Dict):
    """(heads, kv heads, D_qk, D_v)."""
    return (c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"], c["head_dim"])


def _attention_leaves(c: Dict) -> List[layout.Leaf]:
    d, h, kv, hd = (c["hidden_size"], c["num_attention_heads"],
                    c["num_key_value_heads"], c["head_dim"])
    return [layout.normal(("attn", "wq", "w"), (d, h * hd), d),
            layout.normal(("attn", "wk", "w"), (d, kv * hd), d),
            layout.normal(("attn", "wv", "w"), (d, kv * hd), d),
            layout.normal(("attn", "wo", "w"), (h * hd, d), h * hd)]


def leaves(c: Dict) -> List[layout.Leaf]:
    one = layout.block(c, _attention_leaves(c),
                       layout.swiglu(("mlp",), c["hidden_size"],
                                     c["intermediate_size"]))
    return layout.top(c) + layout.stack(one, "layers",
                                        c["num_hidden_layers"])


def active_params(c: Dict) -> int:
    """Parameters of a token's products: every layer's and the head's."""
    d = c["hidden_size"]
    per_layer = (sum(leaf.numel for leaf in _attention_leaves(c))
                 + 3 * d * c["intermediate_size"])
    return c["num_hidden_layers"] * per_layer + d * c["vocab_size"]


class Model(Decoder):
    def layers(self):
        return [(f"layers.{i}.", "mlp")
                for i in range(self.c["num_hidden_layers"])]

    def attention(self, p, pre, x):
        c, mm = self.c, self.mm
        b, s, _ = x.shape
        h, kh, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
        q = linear(x, p[pre + "attn.wq.w"], mm).view(b, s, h, hd)
        k = linear(x, p[pre + "attn.wk.w"], mm).view(b, s, kh, hd)
        v = linear(x, p[pre + "attn.wv.w"], mm).view(b, s, kh, hd)
        o = attention(rope(q, self.theta), rope(k, self.theta), v,
                      hd ** -0.5, mm)
        return linear(o.reshape(b, s, h * hd), p[pre + "attn.wo.w"], mm)
