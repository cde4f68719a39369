"""Where the reduced whisper's f32 parity error comes from, per input.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/encdec_parity_witness.py \
        [--seeds 0,1,2,3] [--per-layer-fan-in]

For reduced whisper-large-v3 (the reference's ``jax.random.PRNGKey(0)``
parameters as drawn, or with ``--per-layer-fan-in`` with every stacked
layer matrix rescaled to its own fan-in, as the tests take them, carried
into the port), on the CPU, at the shapes of
``tests/test_torch_encdec.py``: forward logits of 2 rows at 32 frames
and 32 tokens and at 64 frames and 16 tokens, from each numpy seed, and
12 decode steps of one row over cross caches filled from the encoder's
output of ``ENC_LEN_DECODE`` frames.  For each: the largest
|reference - f64|, |port - f64| and |port - reference|, where f64 is the
port's f64 evaluation, and the port's |port - f64| again with every f32
product evaluated ``split`` (two halves of K) and ``exact`` (in f64,
rounded once to f32), as ``tools/moe_parity_witness.py`` does.  If the
port's excess error falls under ``exact`` to the reference's level, the
excess is the host GEMM's rounding and not a difference in the
function.

With ``--full-width-cut`` it measures instead the cut that
``chip_smoke.py`` phase 3 holds card against host: whisper at full width
with 2 encoder and 2 decoder layers, forward logits of 2 rows of 128
seeded frames and tokens, with the init's weights as drawn and with
every stacked layer matrix rescaled to its own fan-in
(``chip_smoke.per_layer_fan_in``): |f32 - f64|, |split - f64| and
|f32 - split| (two host f32 evaluations that differ only in their
products' summation order) over the logit scale, and how far the f64
logits move when the f32 rope table (``nn/rope.py::rope_freqs``, f32 in
both packages) moves one ulp.  About 1 min and a few GB on the host.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TOOLS, os.path.dirname(TOOLS)]
from chip_smoke import fill_cross, per_layer_fan_in  # noqa: E402
from moe_parity_witness import Products  # noqa: E402


def main() -> None:
    from repro.configs import get_config as jax_get_config
    from repro.models import encdec as jencdec
    from repro.nn.core import apply_dense as jax_apply_dense
    from repro.serve.decode import decode_step as jax_decode_step
    from repro.serve.decode import init_caches as jax_init_caches
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_large_v3 import ENC_LEN_DECODE
    from repro_torch.models import encdec, lm
    from repro_torch.models.convert import params_from_jax
    from repro_torch.nn.core import apply_dense
    from repro_torch.serve import decode_step, init_caches

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--per-layer-fan-in", action="store_true")
    ap.add_argument("--full-width-cut", action="store_true")
    args = ap.parse_args()
    if args.full_width_cut:
        return full_width_cut()
    arch = "whisper-large-v3"
    jcfg = jax_get_config(arch, reduced=True)
    tree = jax.tree.map(np.asarray,
                        jencdec.init_model(jcfg, jax.random.PRNGKey(0)))
    if args.per_layer_fan_in:
        tree = per_layer_fan_in(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(arch, reduced=True)
    cfg64 = cfg.replace(dtype="float64")
    params, params64 = params_from_jax(tree, cfg), params_from_jax(tree,
                                                                   cfg64)

    def err(x, ref):
        return float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(ref, np.float64)).max())

    def report(what, want, port_fn):
        exact = port_fn(params64, cfg64)
        got = port_fn(params, cfg)
        other = {}
        for how in ("split", "exact"):
            with Products(how):
                other[how] = err(port_fn(params, cfg), exact)
        print(f"{what}: |ref - f64| {err(want, exact):.3e}, |port - f64| "
              f"{err(got, exact):.3e}, |port - ref| {err(got, want):.3e}; "
              f"port |split - f64| {other['split']:.3e}, |exact - f64| "
              f"{other['exact']:.3e}; max|logit| {np.abs(exact).max():.1f}",
              flush=True)

    for n_frames, n_tokens in ((32, 32), (64, 16)):
        for seed in map(int, args.seeds.split(",")):
            rng = np.random.default_rng(seed)
            frames = rng.standard_normal((2, n_frames, cfg.d_model)).astype(
                np.float32)
            tokens = rng.integers(0, cfg.vocab, (2, n_tokens))
            want = jencdec.forward(jparams, jnp.asarray(frames),
                                   jnp.asarray(tokens, jnp.int32), jcfg)
            with torch.no_grad():
                report(f"forward {n_frames} frames {n_tokens} tokens seed "
                       f"{seed}", want,
                       lambda p, c: encdec.forward(
                           p, torch.from_numpy(frames),
                           torch.from_numpy(tokens), c).numpy())

    rng = np.random.default_rng(4)
    frames = rng.standard_normal((1, ENC_LEN_DECODE, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, (1, 12))
    jenc = jencdec.encode(jparams, jnp.asarray(frames), jcfg)
    jcaches = fill_cross(
        jcfg, [jax.tree.map(lambda a: a[li], jparams["dec_layers"])
               for li in range(jcfg.dec_layers)], jenc,
        jax_init_caches(jcfg, 1, 12), jax_apply_dense)
    want = []
    for pos in range(12):
        logits, jcaches = jax_decode_step(
            jparams, jcaches, jnp.asarray(tokens[:, pos:pos + 1], jnp.int32),
            pos, jcfg)
        want.append(np.asarray(logits))

    def port_decode(p, c):
        tt = torch.from_numpy(tokens)
        enc_out = encdec.encode(p, torch.from_numpy(frames), c)
        caches = fill_cross(c, lm._unstack(p["dec_layers"], c.dec_layers),
                            enc_out, init_caches(c, 1, 12), apply_dense)
        out = []
        for pos in range(12):
            logits, caches = decode_step(p, caches, tt[:, pos:pos + 1], pos,
                                         c)
            out.append(logits.numpy())
        return np.stack(out, 1)

    with torch.no_grad():
        report("decode over encoder caches seed 4", np.stack(want, 1),
               port_decode)


def full_width_cut() -> None:
    import repro_torch.nn.rope as rope
    from repro_torch.configs import get_config
    from repro_torch.models import encdec

    def cast(t, dtype):
        return {k: cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in t.items()}

    cfg = get_config("whisper-large-v3").replace(
        n_layers=4, enc_layers=2, dec_layers=2, dtype="float32")
    cfg64 = cfg.replace(dtype="float64")
    drawn = encdec.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    real_freqs = rope.rope_freqs

    def one_ulp(head_dim, theta=10000.0, device=None):
        f = real_freqs(head_dim, theta, device)
        return torch.nextafter(f, torch.full_like(f, 2.0))

    for name, params in (("the init's weights", drawn),
                         ("per-layer fan-in", per_layer_fan_in(drawn))):
        with torch.no_grad():
            f32 = encdec.forward(params, frames, tokens, cfg).double()
            with Products("split"):
                split = encdec.forward(params, frames, tokens, cfg).double()
            p64 = cast(params, torch.float64)
            f64 = encdec.forward(p64, frames, tokens, cfg64)
            rope.rope_freqs = one_ulp
            moved = encdec.forward(p64, frames, tokens, cfg64)
            rope.rope_freqs = real_freqs
        scale = f64.abs().max().item()

        def rel(a, b):
            return (a - b).abs().max().item() / scale

        print(f"full width, 2 + 2 layers, {name}: max|logit| {scale:.1f}; "
              f"over it |f32 - f64| {rel(f32, f64):.3e}, |split - f64| "
              f"{rel(split, f64):.3e}, |f32 - split| {rel(f32, split):.3e}; "
              f"f64 with the rope table one ulp up {rel(moved, f64):.3e}",
              flush=True)


if __name__ == "__main__":
    main()
