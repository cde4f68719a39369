"""PPO with a CNN state encoder and invalid-action masking (paper §3.7).

Port of ``repro/core/ppo.py``.  The actor-critic is an ``nn.Module``
(:class:`Agent`): the state matrix from :mod:`repro_torch.core.embedding`
is encoded by a 1-D CNN over the instruction axis, followed by MLP
actor/critic heads.  Hyperparameters and implementation choices
(orthogonal init, Adam eps 1e-5, advantage normalization, clipped value
loss, linear LR anneal) follow the "37 implementation details of PPO"
study the paper takes its defaults from [11].

Randomness comes from explicit ``torch.Generator`` s, never from global
state: :func:`init_agent` draws the parameters on the CPU (the same
parameters whatever the agent's device), the caller's generator on the
agent's device draws actions (:func:`sample_action`) and the minibatch
permutations it hands to the update (:func:`make_update_fn`).  Torch
cannot replay ``jax.random``, so the port is held against the reference
by carrying parameters across (:func:`agent_from_jax`,
:func:`agent_to_jax`) and feeding both the same permutations.

On the card, cuDNN runs f32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the reference computes the
agent in f32, and ``launch.optimize`` sets the flag False.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.optim import adam

_NEG = -1e9


@dataclasses.dataclass
class PPOConfig:
    # defaults from Huang et al. [11] as used by the paper (§3.7, §5.5)
    lr: float = 2.5e-4
    num_envs: int = 8
    num_steps: int = 128            # rollout length per env per update
    total_timesteps: int = 16_384
    gamma: float = 0.99
    gae_lambda: float = 0.95
    num_minibatches: int = 4
    update_epochs: int = 4
    clip_coef: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    anneal_lr: bool = True
    seed: int = 0
    episode_length: int = 32    # §5.7.2: increase if no lingering observed
    warm_start: bool = False    # beyond-paper: episodes resume from the
                                # incumbent best schedule (see §Perf)
    hop_sizes: tuple = (1,)     # beyond-paper: macro moves (see §Perf)

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.num_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches

    @property
    def num_updates(self) -> int:
        return max(1, self.total_timesteps // self.batch_size)


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

class Agent(nn.Module):
    """The reference's ``init_agent``/``policy_value`` network: calling it
    on a state is ``policy_value``.

    Two SAME, stride-2 1-D convolutions (kernel 5, ``padding=2``, giving
    ``ceil(N/2)`` rows each, as the reference's im2col convolution) with
    ReLU, then the mean and the max over the instruction axis
    concatenated, a ReLU fc layer, and linear actor and critic heads."""

    def __init__(self, feat_dim: int, num_actions: int, channels: int = 64,
                 hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv1d(feat_dim, channels, 5, stride=2, padding=2)
        self.conv2 = nn.Conv1d(channels, channels, 5, stride=2, padding=2)
        self.fc = nn.Linear(2 * channels, hidden)
        self.actor = nn.Linear(hidden, num_actions)
        self.critic = nn.Linear(hidden, 1)

    def forward(self, state: torch.Tensor):
        """state: (B, N, F) -> (logits (B, A), value (B,))."""
        x = F.relu(self.conv1(state.transpose(1, 2)))
        x = F.relu(self.conv2(x))                        # (B, C, ceil(N/4))
        feat = torch.cat([x.mean(dim=2), x.amax(dim=2)], dim=-1)
        h = F.relu(self.fc(feat))
        return self.actor(h), self.critic(h)[..., 0]

    @property
    def device(self) -> torch.device:
        return self.actor.weight.device


def _orthogonal(gen: torch.Generator, shape, gain: float = 1.0):
    """The reference's ``_orthogonal``: an orthogonal matrix over the
    flattened (prod(shape[:-1]), shape[-1]) view, drawn on the CPU."""
    flat = (int(np.prod(shape[:-1])), shape[-1])
    a = torch.randn(flat, generator=gen)
    q, r = torch.linalg.qr(a if flat[0] >= flat[1] else a.T)
    q = q * torch.sign(torch.diagonal(r))
    if flat[0] < flat[1]:
        q = q.T
    return (gain * q[: flat[0], : flat[1]]).reshape(shape)


# the layers, by the prefix of the reference's parameter names
_LAYERS = ("conv1", "conv2", "fc", "actor", "critic")
_CONVS = ("conv1", "conv2")


def _agent_with(params: Dict, device) -> Agent:
    """An :class:`Agent` on ``device`` holding reference-layout parameters
    (conv weights (K, C_in, C_out), dense weights (in, out)) as
    (C_out, C_in, K) and ``Linear.weight`` (out, in).  The module is
    built on the meta device, so its default initialisation draws
    nothing from the global generator."""
    ks, feat_dim, channels = np.shape(params["conv1_w"])
    hidden, num_actions = np.shape(params["actor_w"])
    if ks != 5:
        raise ValueError(f"conv1_w: kernel width {ks}, the agent's is 5")
    with torch.device("meta"):
        agent = Agent(feat_dim, num_actions, channels, hidden)
    agent = agent.to_empty(device=device if device is not None else "cpu")
    with torch.no_grad():
        for name in _LAYERS:
            layer = getattr(agent, name)
            w = torch.tensor(np.asarray(params[f"{name}_w"], np.float32))
            w = w.permute(2, 1, 0) if name in _CONVS else w.T
            if tuple(w.shape) != tuple(layer.weight.shape):
                raise ValueError(f"{name}_w: shape {tuple(w.shape)} does not "
                                 f"fit {tuple(layer.weight.shape)}")
            layer.weight.copy_(w)
            layer.bias.copy_(torch.tensor(
                np.asarray(params[f"{name}_b"], np.float32)))
    return agent


def init_agent(gen: torch.Generator, n_rows: int, feat_dim: int,
               num_actions: int, channels: int = 64, hidden: int = 256,
               device=None) -> Agent:
    """The reference's orthogonal initialisation (conv and fc gain √2,
    actor 0.01, critic 1; zero biases), drawn from the CPU generator
    ``gen`` and placed on ``device``.  ``n_rows`` is unused, as in the
    reference (the pooling makes the network width-independent)."""
    s2 = float(np.sqrt(2.0))
    params = {
        "conv1_w": _orthogonal(gen, (5, feat_dim, channels), s2),
        "conv2_w": _orthogonal(gen, (5, channels, channels), s2),
        "fc_w": _orthogonal(gen, (2 * channels, hidden), s2),
        "actor_w": _orthogonal(gen, (hidden, num_actions), 0.01),
        "critic_w": _orthogonal(gen, (hidden, 1), 1.0),
    }
    for name, shape in (("conv1", channels), ("conv2", channels),
                        ("fc", hidden), ("actor", num_actions),
                        ("critic", 1)):
        params[f"{name}_b"] = torch.zeros(shape)
    return _agent_with({k: v.numpy() for k, v in params.items()}, device)


def agent_from_jax(params: Dict, device=None) -> Agent:
    """An :class:`Agent` holding the reference's parameter dict
    (``init_agent``'s keys, numpy leaves) on ``device``."""
    return _agent_with(params, device)


def agent_to_jax(agent: Agent) -> Dict[str, np.ndarray]:
    """The inverse of :func:`agent_from_jax`: the reference's parameter
    dict (f32 numpy leaves) of ``agent``."""
    out = {}
    for name in _LAYERS:
        layer = getattr(agent, name)
        w = layer.weight.detach().cpu()
        w = w.permute(2, 1, 0) if name in _CONVS else w.T
        out[f"{name}_w"] = w.numpy().copy()
        out[f"{name}_b"] = layer.bias.detach().cpu().numpy().copy()
    return out


def masked_logits(logits, mask):
    return torch.where(mask > 0, logits, _NEG)


def masked_log_probs(logits, mask):
    return F.log_softmax(masked_logits(logits, mask), dim=-1)


def masked_entropy(logits, mask):
    lp = masked_log_probs(logits, mask)
    p = torch.exp(lp)
    return -torch.sum(torch.where(mask > 0, p * lp, 0.0), dim=-1)


@torch.no_grad()
def sample_action(agent: Agent, gen: torch.Generator, state, mask):
    """Batched action sampling under the mask (assigning 'an impossible
    probability' to invalid actions, §3.5); ``gen`` lives on the agent's
    device."""
    logits, value = agent(state)
    lp = masked_log_probs(logits, mask)
    action = torch.multinomial(torch.exp(lp), 1, generator=gen)
    logprob = torch.gather(lp, 1, action)[:, 0]
    return action[:, 0], logprob, value


@torch.no_grad()
def greedy_action(agent: Agent, state, mask):
    logits, value = agent(state)
    return torch.argmax(masked_logits(logits, mask), dim=-1), value


@torch.no_grad()
def bootstrap_value(agent: Agent, state):
    """Critic-only forward for the GAE bootstrap."""
    return agent(state)[1]


# ---------------------------------------------------------------------------
# GAE + update
# ---------------------------------------------------------------------------

def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """rewards/values/dones: (T, B) float32 arrays on the host (the
    rollout buffers); returns advantages, returns (T, B) — the
    reference's reverse scan, in f32."""
    rewards, values, dones = (np.asarray(a, np.float32)
                              for a in (rewards, values, dones))
    adv_next = np.zeros_like(np.asarray(last_value, np.float32))
    v_next = np.asarray(last_value, np.float32)
    advs = np.empty_like(rewards)
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = np.float32(1.0) - dones[t]
        delta = rewards[t] + gamma * v_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


class UpdateStats(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    clip_frac: torch.Tensor


def _clip(x, lo, hi):
    # jnp.clip's min(max(x, lo), hi): at a bound, a gradient split as
    # jax's max/min split theirs (torch.clamp would pass all of it)
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def make_update_fn(cfg: PPOConfig):
    """(optimizer, update).  ``update(agent, opt_state, batch, perms)``
    runs ``cfg.update_epochs`` epochs of ``cfg.num_minibatches`` Adam
    steps on ``agent``'s parameters in place and returns (the new
    optimizer state, the stats averaged over every minibatch).  ``batch``
    holds (B, ...) tensors on the agent's device; ``perms`` is
    (update_epochs, B): epoch e's minibatch i is
    ``perms[e, i*mb:(i+1)*mb]``, where the reference draws
    ``jax.random.permutation`` inside its update."""
    opt = adam(lambda step: _lr_at(cfg, step), eps=1e-5,
               max_grad_norm=cfg.max_grad_norm)

    def loss_fn(agent, mb):
        logits, value = agent(mb["state"])
        lp_all = masked_log_probs(logits, mb["mask"])
        logprob = torch.gather(lp_all, 1, mb["action"][:, None])[:, 0]
        ratio = torch.exp(logprob - mb["logprob"])
        adv = mb["adv"]
        # jnp.std is the population std; torch.std's default is the
        # sample std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = -adv * ratio
        pg2 = -adv * _clip(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
        pg_loss = torch.maximum(pg1, pg2).mean()
        # clipped value loss
        v_clip = mb["value"] + _clip(value - mb["value"], -cfg.clip_coef,
                                     cfg.clip_coef)
        v_loss = 0.5 * torch.maximum((value - mb["ret"]) ** 2,
                                     (v_clip - mb["ret"]) ** 2).mean()
        ent = masked_entropy(logits, mb["mask"]).mean()
        loss = pg_loss - cfg.ent_coef * ent + cfg.vf_coef * v_loss
        with torch.no_grad():
            approx_kl = ((ratio - 1.0) - torch.log(ratio)).mean()
            clip_frac = ((ratio - 1.0).abs() > cfg.clip_coef).float().mean()
        return loss, UpdateStats(pg_loss.detach(), v_loss.detach(),
                                 ent.detach(), approx_kl, clip_frac)

    def update(agent: Agent, opt_state, batch: Dict[str, torch.Tensor],
               perms: torch.Tensor):
        params = dict(agent.named_parameters())
        names = list(params)
        if perms.shape != (cfg.update_epochs, batch["action"].shape[0]):
            raise ValueError(f"perms: need ({cfg.update_epochs}, "
                             f"{batch['action'].shape[0]}), got "
                             f"{tuple(perms.shape)}")
        stats = []
        for epoch in range(cfg.update_epochs):
            idxs = perms[epoch].reshape(cfg.num_minibatches,
                                        cfg.minibatch_size)
            for idx in idxs:
                mb = {k: v[idx] for k, v in batch.items()}
                loss, st = loss_fn(agent, mb)
                grads = torch.autograd.grad(loss, [params[n] for n in names])
                updates, opt_state = opt.update(dict(zip(names, grads)),
                                                opt_state, params)
                with torch.no_grad():
                    for n in names:
                        params[n].add_(updates[n])
                stats.append(torch.stack(list(st)))
        mean = torch.stack(stats).mean(dim=0)
        return opt_state, UpdateStats(*mean)

    return opt, update


def _lr_at(cfg: PPOConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at optimizer step ``step`` (Adam's own counter,
    1 at the first step).  The anneal runs over every optimizer step,
    ``num_updates * update_epochs * num_minibatches`` of them."""
    if not cfg.anneal_lr:
        return torch.full((), cfg.lr, dtype=torch.float32,
                          device=step.device)
    total = cfg.num_updates * cfg.update_epochs * cfg.num_minibatches
    frac = 1.0 - torch.clamp(step.float() / max(total, 1), 0.0, 1.0)
    return cfg.lr * torch.clamp(frac, min=0.0) + 1e-8


__all__ = ["Agent", "PPOConfig", "UpdateStats", "agent_from_jax",
           "agent_to_jax", "bootstrap_value", "compute_gae",
           "greedy_action", "init_agent", "make_update_fn",
           "masked_entropy", "masked_log_probs", "masked_logits",
           "sample_action"]

