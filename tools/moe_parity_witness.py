"""Where the reduced moe models' f32 parity error comes from, per input.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_parity_witness.py \
        [--archs olmoe-1b-7b,deepseek-v2-lite-16b] [--seeds 0,1,2,3,4,5] \
        [--batches 0,1,2,3]

For each reduced model (the reference's ``jax.random.PRNGKey(0)``
parameters carried into the port), on the CPU:

- forward logits of (2, 64) tokens from each numpy token seed: the
  largest |reference - f64|, |port - f64| and |port - reference|, where
  f64 is the port's f64 evaluation, and the port's |port - f64| again
  with its products evaluated two other ways: ``split``, every f32
  product summed as two halves of K (another summation order of the same
  function), and ``exact``, every f32 product evaluated in f64 and
  rounded once to f32 (no GEMM summation error at all);
- one train step's gradients on each batch of ``make_data(cfg, 32, 4,
  seed=5)``: the grad-norm's relative |reference - f64| and
  |port - reference|, and the largest ratio, over the gradient leaves, of
  |port - reference| to |reference - f64|.

If the port's excess error on an input falls under ``split`` or
``exact`` to the reference's level, the excess is the host GEMM's
rounding and not a difference in the function.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class Products(TorchFunctionMode):
    """Evaluates every f32 product ``a @ b`` as ``split`` (the sum of the
    products of K's two halves) or ``exact`` (in f64, rounded to f32)."""

    def __init__(self, how):
        super().__init__()
        self.how = how

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and args[0].dtype == torch.float32:
            a, b = args
            if self.how == "exact":
                return (a.double() @ b.double()).float()
            h = a.shape[-1] // 2
            return a[..., :h] @ b[..., :h, :] + a[..., h:] @ b[..., h:, :]
        return func(*args, **kwargs)


def main() -> None:
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import make_data as jax_make_data
    from repro.models import lm as jlm
    from repro.train.step import loss_fn as jax_loss_fn
    from repro.utils.tree import global_norm as jax_global_norm
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train import compute_grads
    from repro_torch.utils.tree import global_norm, tree_leaves

    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="olmoe-1b-7b,deepseek-v2-lite-16b")
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--batches", default="0,1,2,3")
    args = ap.parse_args()
    for arch in args.archs.split(","):
        jcfg = jax_get_config(arch, reduced=True)
        jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        cfg = get_config(arch, reduced=True)
        cfg64 = cfg.replace(dtype="float64")
        params = params_from_jax(tree, cfg)
        params64 = params_from_jax(tree, cfg64)
        for seed in map(int, args.seeds.split(",")):
            tokens = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                          (2, 64))
            tt = torch.from_numpy(tokens)
            want = np.asarray(jlm.forward(
                jparams, jnp.asarray(tokens, jnp.int32), jcfg), np.float64)
            exact = lm.forward(params64, tt, cfg64).detach().numpy()

            def err(x, ref):
                return float(np.abs(np.asarray(x, np.float64) - ref).max())

            with torch.no_grad():
                got = lm.forward(params, tt, cfg).numpy()
                other = {}
                for how in ("split", "exact"):
                    with Products(how):
                        other[how] = err(lm.forward(params, tt, cfg).numpy(),
                                         exact)
            print(f"{arch} logits seed {seed}: |ref - f64| "
                  f"{err(want, exact):.3e}, |port - f64| {err(got, exact):.3e}"
                  f", |port - ref| {err(got, want):.3e}; port |split - f64| "
                  f"{other['split']:.3e}, |exact - f64| {other['exact']:.3e}",
                  flush=True)
        data = jax_make_data(jcfg, 32, 4, seed=5)
        for i in map(int, args.batches.split(",")):
            nb = data.batch_at(i)
            jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
            batch = {k: torch.from_numpy(v) for k, v in nb.items()}
            _, jgrads = jax.value_and_grad(
                lambda p: jax_loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
            _, grads = compute_grads(params_from_jax(tree, cfg), batch, cfg)
            _, g64 = compute_grads(params64, batch, cfg64)
            e = float(global_norm(g64))
            j = float(jax_global_norm(jgrads))
            p = float(global_norm(grads))
            ratio = max(
                float(np.abs(g.numpy() - np.asarray(jg)).max())
                / max(float(np.abs(np.asarray(jg) - x.numpy()).max()), 1e-30)
                for g, jg, x in zip(tree_leaves(grads),
                                    jax.tree.leaves(jgrads), tree_leaves(g64)))
            print(f"{arch} batch {i}: grad-norm |ref - f64| "
                  f"{abs(j - e) / e:.3e}, |port - f64| {abs(p - e) / e:.3e}, "
                  f"|port - ref| {abs(p - j) / j:.3e} (relative); largest "
                  f"leaf |port - ref| / |ref - f64| {ratio:.3f}", flush=True)


if __name__ == "__main__":
    main()
