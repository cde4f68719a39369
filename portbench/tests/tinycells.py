"""Tiny stand-ins of the cells for the CPU tests: every width shrunk,
float32, a few short rows."""

import copy
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SHRINK = {
    "deepseek_v2": dict(hidden_size=64, num_attention_heads=4,
                        num_key_value_heads=4, kv_lora_rank=32,
                        qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16, n_routed_experts=8,
                        num_experts_per_tok=2, n_shared_experts=1,
                        moe_intermediate_size=48, intermediate_size=192,
                        vocab_size=256, num_hidden_layers=3),
    "stablelm": dict(hidden_size=64, num_attention_heads=4,
                     num_key_value_heads=4, head_dim=16,
                     intermediate_size=128, vocab_size=256,
                     num_hidden_layers=2),
}


def shrink_config(c):
    c = copy.deepcopy(c)
    c.update(SHRINK[c["model_type"]])
    c["port"]["set"]["dtype"] = "float32"
    return c


def shrink_mix(mix):
    return dict(mix, seq_len=32, batch=max(2, mix["batch"] // 2))


def tiny_root(tmp):
    """A checkout at ``tmp`` whose BENCHMARK.json and portbench/ are the
    real ones with every configuration and mix shrunk."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub, fix in (("configs", shrink_config), ("mixes", shrink_mix)):
        d = os.path.join(tmp, "portbench", sub)
        for name in os.listdir(d):
            path = os.path.join(d, name)
            with open(path) as f:
                data = fix(json.load(f))
            with open(path, "w") as f:
                json.dump(data, f)
    return tmp
