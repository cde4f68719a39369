"""Where a reduced model's f32 decode error comes from, pass by pass.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/decode_parity_witness.py \
        [--arch qwen1.5-4b] [--per-layer-fan-in] [--seeds 10]

For a reduced model (the reference's ``jax.random.PRNGKey(0)``
parameters as drawn, or with ``--per-layer-fan-in`` with every stacked
layer matrix rescaled to its own fan-in, carried into the port), on the
CPU, over the 12 decode passes of 4 rows that
``tests/test_torch_gspmd_serve.py`` holds (its ``_spec`` tokens, caches
of 32), without a mesh: the largest |logits - f64| at each pass, where
f64 is the port's f64 decode, for

- ``ref_f32``: the reference's f32 decode;
- ``port_f32``: the port's f32 decode;
- ``port_f32_<ops>_f64``: the port's f32 decode with one family of ops
  evaluated in f64 and rounded once to f32: ``products`` (every matrix
  product), ``norms`` (``rsqrt``/``sqrt``), ``rope`` (``sin``/``cos``);
- ``f64_noise_{min,median,max}``: over ``--seeds`` seeds, the port's f64
  decode with every product's output moved by a relative error drawn
  uniform in +-2^-24 (half an f32 ulp, nothing else rounded);

and the largest and mean error, in f32 ulps, of each package's f32
``rsqrt`` (the norms' op) over 10^6 values drawn uniform in [0.01, 100).

If one family alone carried the port's excess error, evaluating it in
f64 would bring the port to the f64 decode's level while the others
changed nothing; if every family moves the error by factors either way
and half-ulp noise alone spreads it as widely, the error is f32 rounding
amplified by the input, not a difference in the function.  Prints one
JSON object a line.  About 1 min on the host.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                ROOT]

from chip_smoke import per_layer_fan_in  # noqa: E402

PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.mm, torch.bmm, torch.einsum, torch.nn.functional.linear,
            torch.addmm, torch.baddbmm}
FAMILIES = {"products": PRODUCTS,
            "norms": {torch.rsqrt, torch.Tensor.rsqrt, torch.sqrt,
                      torch.Tensor.sqrt},
            "rope": {torch.sin, torch.cos, torch.Tensor.sin,
                     torch.Tensor.cos}}


def _up(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.double()
    if isinstance(x, (list, tuple)):
        return type(x)(_up(y) for y in x)
    return x


class Wide(TorchFunctionMode):
    """Evaluates the ops ``fns`` on f32 inputs in f64, rounded once to
    f32."""

    def __init__(self, fns):
        super().__init__()
        self.fns = fns

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.fns and any(
                isinstance(a, torch.Tensor) and a.dtype == torch.float32
                for a in args):
            r = func(*_up(args), **{k: _up(v) for k, v in kwargs.items()})
            return r.float() if isinstance(r, torch.Tensor) \
                and r.dtype == torch.float64 else r
        return func(*args, **kwargs)


class Noise(TorchFunctionMode):
    """Moves every f64 product's output by a relative error uniform in
    +-2^-24, drawn from ``seed``."""

    def __init__(self, seed):
        super().__init__()
        self.gen = torch.Generator().manual_seed(seed)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        r = func(*args, **(kwargs or {}))
        if func in PRODUCTS and isinstance(r, torch.Tensor) \
                and r.dtype == torch.float64:
            u = torch.rand(r.shape, generator=self.gen, dtype=torch.float64)
            r = r * (1 + (2 * u - 1) * 2.0 ** -24)
        return r


def main() -> None:
    from repro.configs import get_config as jax_get_config
    from repro.models import lm as jlm
    from repro.serve.decode import decode_step as jax_decode_step
    from repro.serve.decode import init_caches as jax_init_caches
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import decode_step
    from repro_torch.serve.decode import init_caches
    from test_torch_gspmd_serve import _spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--per-layer-fan-in", action="store_true")
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    spec = _spec()
    steps = np.asarray(spec["logits"]["tokens"][args.arch])
    max_seq = spec["generate"]["max_seq"]
    jcfg = jax_get_config(args.arch, reduced=True)
    jparams = jax.tree.map(np.asarray,
                           jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    if args.per_layer_fan_in:
        jparams = per_layer_fan_in(jparams)
    cfg = get_config(args.arch, reduced=True)

    def port(dtype, mode=None):
        c = cfg.replace(dtype=dtype)
        params = params_from_jax(jparams, c)
        caches = init_caches(c, steps.shape[1], max_seq)
        out = []
        with (mode if mode is not None else torch.no_grad()):
            for i, tok in enumerate(steps):
                logits, caches = decode_step(params, caches,
                                             torch.tensor(tok), i, c)
                out.append(logits.double().numpy())
        return out

    def reference():
        caches = jax_init_caches(jcfg, steps.shape[1], max_seq)
        step = jax.jit(lambda p, c, t, pos: jax_decode_step(p, c, t, pos,
                                                            jcfg))
        out = []
        for i, tok in enumerate(steps):
            logits, caches = step(jparams, caches,
                                  jnp.asarray(tok, jnp.int32), jnp.int32(i))
            out.append(np.asarray(logits, np.float64))
        return out

    exact = port("float64")

    def err(run):
        return [float(np.abs(a - b).max()) for a, b in zip(run, exact)]

    rows = {"ref_f32": err(reference()), "port_f32": err(port("float32"))}
    for name, fns in FAMILIES.items():
        rows[f"port_f32_{name}_f64"] = err(port("float32", Wide(fns)))
    noise = np.asarray([err(port("float64", Noise(s)))
                        for s in range(args.seeds)])
    rows["f64_noise_min"] = noise.min(0).tolist()
    rows["f64_noise_median"] = np.median(noise, 0).tolist()
    rows["f64_noise_max"] = noise.max(0).tolist()
    head = {"arch": args.arch, "per_layer_fan_in": args.per_layer_fan_in,
            "logit_scale": float(np.abs(np.stack(exact)).max()),
            "seeds": args.seeds}
    x = np.random.default_rng(0).uniform(0.01, 100, 10 ** 6).astype(
        np.float32)
    truth = 1 / np.sqrt(x.astype(np.float64))
    ulp = np.spacing(truth.astype(np.float32)).astype(np.float64)
    for pkg, y in (("ref", jax.jit(jax.lax.rsqrt)(jnp.asarray(x))),
                   ("port", torch.rsqrt(torch.from_numpy(x)))):
        e = np.abs(np.asarray(y, np.float64) - truth) / ulp
        head[f"{pkg}_rsqrt_ulps_max"] = float(e.max())
        head[f"{pkg}_rsqrt_ulps_mean"] = float(e.mean())
    print(json.dumps(head))
    for name, errs in rows.items():
        print(json.dumps({"run": name, "err_by_pass": errs}))


if __name__ == "__main__":
    main()
