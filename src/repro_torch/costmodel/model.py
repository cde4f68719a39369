"""The learned cycle predictor: a small MLP over schedule features.

Trained on :class:`repro_torch.costmodel.dataset.CostDataset` with two
heads sharing one scalar output:

* **MSE on log-cycles** — absolute calibration, so predictions stay
  comparable across kernels of very different magnitudes;
* **pairwise ranking loss over same-kernel pairs** (the CUDA-L1 recipe,
  2507.14111): for two schedules of one program, a logistic loss on the
  prediction difference signed by the measured ordering.  Search only
  needs *ranking* to be right — the top-k candidates it verifies on the
  real timer are chosen by order, not by value — so the ranking head
  optimizes exactly the quantity the beam consumes.

Port of ``repro/costmodel/model.py``.  The parameters are a flat dict of
f32 tensors (``w0, b0, w1, b1, ...``, weights (in, out) as the
reference's) on the model's device, the card unless ``fit`` is asked for
another.  ``fit`` is bit-reproducible under a fixed seed on any one
device: the initial parameters come from a CPU ``torch.Generator``
seeded once, batch indices from ``np.random.default_rng(seed)`` exactly
as the reference draws them (so both packages train on the same
batches), each batch is built on the host and copied over, and the step
has no scatter or atomic add.  Torch cannot replay ``jax.random``, so
the two packages' initial parameters differ; they cross through the
reference's ``repro-cost-model`` v1 ``.npz`` (:meth:`CostModel.save` /
:meth:`CostModel.load`) or :meth:`CostModel.from_numpy`.  Unknown
versions raise
:class:`~repro_torch.costmodel.dataset.CostModelVersionError` (the
schedule cache / measurement memo convention).
"""

from __future__ import annotations

import zipfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.costmodel.dataset import (FEATURE_VERSION, CostDataset,
                                           CostModelVersionError)
from repro_torch.optim import adam
from repro_torch.optim.adamw import apply_updates
from repro_torch.utils.device import resolve_device

MODEL_FORMAT = "repro-cost-model"
MODEL_VERSION = 1
_KNOWN_MODEL_VERSIONS = (1,)

DEFAULT_HIDDEN = (64, 64)


class CostModel:
    """MLP cycle predictor: ``init`` / ``apply`` / ``loss`` plus the
    convenience ``fit`` / ``predict_log`` / ``save`` / ``load`` wrappers.

    ``params`` is a flat dict of f32 tensors (``w0, b0, w1, b1, ...``) on
    one device; ``norm`` holds the feature/target standardization (means
    and scales, numpy) learned from the training split — kept outside the
    gradient tree.
    """

    def __init__(self, params: Dict[str, torch.Tensor],
                 norm: Dict[str, np.ndarray],
                 feature_version: int = FEATURE_VERSION):
        self.params = params
        self.norm = norm
        self.feature_version = int(feature_version)

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray],
                   norm: Dict[str, np.ndarray],
                   feature_version: int = FEATURE_VERSION,
                   device=None) -> "CostModel":
        """A model holding the reference's parameter dict (numpy leaves,
        as ``np.asarray`` of its jnp arrays) on ``device`` (default: the
        card)."""
        dev = resolve_device(device)
        return cls({k: torch.tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in params.items()},
                   {k: np.asarray(v) for k, v in norm.items()},
                   feature_version)

    @property
    def device(self) -> torch.device:
        return self.params["w0"].device

    # -- the three core functions --------------------------------------------

    @staticmethod
    def init(gen: torch.Generator, in_dim: int,
             hidden: Sequence[int] = DEFAULT_HIDDEN,
             device=None) -> Dict[str, torch.Tensor]:
        """He-normal weights and zero biases, drawn from the CPU generator
        ``gen`` (the same parameters whatever ``device``)."""
        dims = (int(in_dim),) + tuple(hidden) + (1,)
        params: Dict[str, torch.Tensor] = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((a, b), generator=gen) * float(np.sqrt(2.0 / a))
            params[f"w{i}"] = w.to(device)
            params[f"b{i}"] = torch.zeros((b,), device=device)
        return params

    @staticmethod
    def apply(params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        """Normalized-log-cycle predictions for normalized features."""
        n_layers = len(params) // 2
        h = x
        for i in range(n_layers - 1):
            h = F.relu(h @ params[f"w{i}"] + params[f"b{i}"])
        last = n_layers - 1
        return (h @ params[f"w{last}"] + params[f"b{last}"])[..., 0]

    @staticmethod
    def loss(params: Dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor, group: torch.Tensor, rank_weight: float = 1.0
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """MSE + pairwise same-group ranking loss over one batch.

        Every ordered pair (i, j) in the batch with ``group[i] == group[j]``
        and a measurable target difference contributes
        ``softplus(-sign(y_i - y_j) * (pred_i - pred_j))`` — minimized when
        the prediction difference agrees in sign (and grows in margin) with
        the measured one.
        """
        pred = CostModel.apply(params, x)
        mse = torch.mean((pred - y) ** 2)
        dp = pred[:, None] - pred[None, :]
        dy = y[:, None] - y[None, :]
        same = (group[:, None] == group[None, :]) & (torch.abs(dy) > 1e-6)
        pair = F.softplus(-torch.sign(dy) * dp)
        rank = (torch.sum(torch.where(same, pair, 0.0))
                / torch.clamp(torch.sum(same), min=1))
        return mse + rank_weight * rank, (mse, rank)

    # -- training ------------------------------------------------------------

    @classmethod
    def fit(cls, dataset: CostDataset, steps: int = 1500, seed: int = 0,
            batch_size: int = 256, lr: float = 1e-3,
            hidden: Sequence[int] = DEFAULT_HIDDEN,
            rank_weight: float = 1.0, verbose: bool = False,
            device=None) -> Tuple["CostModel", List[Dict]]:
        """Train on the dataset's train split on ``device`` (default: the
        card); returns (model, history).

        Bit-reproducible under a fixed ``seed`` on one device: re-running
        this call on the same dataset yields parameter tensors that
        compare equal.
        """
        dev = resolve_device(device)
        train = dataset.train
        if len(train) < 2:
            raise ValueError(
                f"cost-model training needs >= 2 train rows, got "
                f"{len(train)} (warm a memo first)")
        X = train.X.astype(np.float32)
        y = train.y.astype(np.float32)
        mu = X.mean(axis=0)
        sigma = X.std(axis=0) + 1e-6
        ymu = np.float32(y.mean())
        ystd = np.float32(y.std() + 1e-6)
        Xn = (X - mu) / sigma
        yn = (y - ymu) / ystd
        norm = {"mu": mu.astype(np.float32),
                "sigma": sigma.astype(np.float32),
                "ymu": np.asarray(ymu, np.float32),
                "ystd": np.asarray(ystd, np.float32)}

        params = cls.init(torch.Generator().manual_seed(seed), X.shape[1],
                          hidden, device=dev)
        opt = adam(lr, max_grad_norm=1.0)
        opt_state = opt.init(params)
        names = sorted(params)

        rng = np.random.default_rng(seed)
        n = Xn.shape[0]
        bs = min(batch_size, n)
        history: List[Dict] = []
        for step in range(int(steps)):
            idx = rng.integers(0, n, size=bs)
            xb = torch.from_numpy(Xn[idx]).to(dev)
            yb = torch.from_numpy(yn[idx]).to(dev)
            gb = torch.from_numpy(train.group[idx]).to(dev)
            leaves = {k: params[k].detach().requires_grad_() for k in names}
            total, (mse, rank) = cls.loss(leaves, xb, yb, gb,
                                          rank_weight=rank_weight)
            grads = torch.autograd.grad(total, [leaves[k] for k in names])
            with torch.no_grad():
                upd, opt_state = opt.update(dict(zip(names, grads)),
                                            opt_state, params)
                params = apply_updates(params, upd)
            if step % 100 == 0 or step == int(steps) - 1:
                row = {"step": step, "loss": float(total.detach()),
                       "mse": float(mse.detach()),
                       "rank": float(rank.detach())}
                history.append(row)
                if verbose:
                    print(f"[costmodel] step={step} loss={row['loss']:.4f} "
                          f"mse={row['mse']:.4f} rank={row['rank']:.4f}")
        return cls(params, norm, dataset.feature_version), history

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def predict_log(self, X: np.ndarray) -> np.ndarray:
        """Predicted log-cycles for raw (unnormalized) feature rows."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        xn = (X - self.norm["mu"]) / self.norm["sigma"]
        pred = CostModel.apply(self.params,
                               torch.from_numpy(xn).to(self.device))
        return (pred.cpu().numpy() * float(self.norm["ystd"])
                + float(self.norm["ymu"]))

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predicted cycles (exp of the log head)."""
        return np.exp(self.predict_log(X))

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the reference's ``repro-cost-model`` v1 ``.npz``."""
        arrays = {f"param_{k}": v.detach().cpu().numpy()
                  for k, v in self.params.items()}
        arrays.update({f"norm_{k}": np.asarray(v)
                       for k, v in self.norm.items()})
        np.savez(path, format=MODEL_FORMAT, version=MODEL_VERSION,
                 feature_version=self.feature_version, **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "CostModel":
        """Read a ``repro-cost-model`` ``.npz`` (either package's) onto
        ``device`` (default: the card)."""
        try:
            with np.load(path, allow_pickle=False) as z:
                if "format" not in z.files \
                        or str(z["format"]) != MODEL_FORMAT:
                    raise CostModelVersionError(
                        f"{path} is not a {MODEL_FORMAT} file")
                version = int(z["version"])
                if version not in _KNOWN_MODEL_VERSIONS:
                    raise CostModelVersionError(
                        f"cost model {path} has version {version!r}; this "
                        f"build reads {_KNOWN_MODEL_VERSIONS}")
                params = {k[len("param_"):]: z[k]
                          for k in z.files if k.startswith("param_")}
                norm = {k[len("norm_"):]: z[k]
                        for k in z.files if k.startswith("norm_")}
                feature_version = int(z["feature_version"])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise CostModelVersionError(
                f"corrupt cost model {path}: {e}") from e
        return cls.from_numpy(params, norm, feature_version, device=device)
