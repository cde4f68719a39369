"""Assembly-game training driver (paper Fig. 3 loop + §4.2 workflow).

Port of ``repro/core/game.py``.  ``train_on_program`` runs PPO over
vectorized copies of the game for one kernel schedule and returns the
best schedule found across the whole run — "the best optimized cubin
found throughout the assembly game is written to the file system" (§4.2).
Training statistics (episodic return, approximate KL divergence, policy
entropy — the paper's Fig. 8 / Fig. 12 time series) are collected per
update.

The environments run on the host (numpy); the agent runs on ``device``
(the card unless the caller asks for the CPU).  The rollout buffers are
numpy arrays on the host, allocated once per run and rewritten in place
(``AssemblyGame.write_obs``).  Each rollout step copies one
``(B, n_rows, F)`` state and its mask to the agent's device and reads B
actions, log-probs and values back in one copy (one sync); each update
copies the batch to the device once.  Every env applies its action first
(``begin_step``) so the step's measurement requests are served *batched*
through one schedule->cycles memo shared by all envs — distinct cache
misses are timed once by the incremental :class:`ScheduleTimer` (and
optionally on a worker pool) and every other env hits the cache.  Memo
hit/miss totals, and the run's wall time split between the agent's calls
(``agent_seconds``: host clock around each call, which ends in a device
sync) and everything else (``env_seconds``: the environments, the memo
and the host), are surfaced in each ``GameResult.stats`` row.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.env import AssemblyGame
from repro_torch.core.isa import Instruction
from repro_torch.core.machine import Machine
from repro_torch.core.ppo import (Agent, PPOConfig, bootstrap_value,
                                  compute_gae, greedy_action, init_agent,
                                  make_update_fn, sample_action)
from repro_torch.core.timing import ScheduleTimer
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class GameResult:
    best_program: List[Instruction]
    best_cycles: float
    baseline_cycles: float
    agent: Agent               # the reference's ``params``: the trained agent
    stats: List[Dict]
    config: PPOConfig

    @property
    def improvement(self) -> float:
        return (self.baseline_cycles - self.best_cycles) / self.baseline_cycles

    @property
    def speedup(self) -> float:
        return self.baseline_cycles / self.best_cycles


def train_on_program(program: Sequence[Instruction],
                     stall_db: Optional[Dict[str, int]] = None,
                     cfg: Optional[PPOConfig] = None,
                     machine_factory: Callable[[], Machine] = Machine,
                     log_every: int = 1,
                     verbose: bool = False,
                     use_fast_measure: bool = True,
                     measure_workers: Optional[int] = None,
                     measure_cache: Optional[Dict[bytes, float]] = None,
                     device=None) -> GameResult:
    """PPO over ``cfg.num_envs`` vectorized games of one kernel schedule,
    with the agent on ``device`` (default: the card; raises without one).

    ``use_fast_measure=False`` routes every reward measurement through the
    full dataflow oracle (``Machine.run``).  ``measure_workers``
    optionally sizes a thread pool over which distinct measurement cache
    misses are primed concurrently; the pure-Python timer is GIL-bound, so
    this pays off only for timing backends that release the GIL — default
    off.  ``measure_cache`` injects an external schedule->cycles memo (a
    session backend's cross-kernel view); default is a fresh run-local one.

    ``cfg.seed`` seeds the agent's initial parameters (drawn on the CPU,
    so they do not depend on ``device``) and a generator on ``device``
    that draws the actions and the update's minibatch permutations.
    """
    cfg = cfg or PPOConfig()
    device = resolve_device(device)
    if measure_cache is None:
        measure_cache = {}
    envs = [AssemblyGame(program, stall_db=stall_db,
                         machine=machine_factory(), input_seed=i,
                         episode_length=cfg.episode_length,
                         warm_start=cfg.warm_start,
                         hop_sizes=cfg.hop_sizes,
                         use_fast_measure=use_fast_measure,
                         measure_cache=measure_cache)
            for i in range(cfg.num_envs)]
    n_rows, feat_dim = envs[0].n, envs[0].feature_dim
    num_actions = max(envs[0].num_actions, 2)

    agent = init_agent(torch.Generator().manual_seed(cfg.seed), n_rows,
                       feat_dim, num_actions, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    opt, update_fn = make_update_fn(cfg)
    opt_state = opt.init(dict(agent.named_parameters()))

    pool = (ThreadPoolExecutor(max_workers=measure_workers)
            if measure_workers and measure_workers > 1 else None)
    # batched re-timing: all envs permute the SAME instruction set, so one
    # step's distinct measurement misses can run through a single dedicated
    # timer whose checkpoints are shared across the whole batch
    # (ScheduleTimer.time_many sorts the orders so lexicographic neighbors
    # resume from each other's prefixes).  A separate timer instance keeps
    # the envs' own incremental trajectories undisturbed.
    batch_timer = (ScheduleTimer(envs[0].original)
                   if pool is None and envs[0]._timer is not None else None)

    for env in envs:
        env.reset()
    ep_returns = [0.0] * cfg.num_envs
    finished_returns: List[float] = []
    stats: List[Dict] = []
    global_step = 0

    # rollout + bootstrap buffers on the host, allocated once and
    # rewritten in place
    T, B = cfg.num_steps, cfg.num_envs
    buf_state = np.zeros((T, B, n_rows, feat_dim), np.float32)
    buf_mask = np.zeros((T, B, num_actions), np.float32)
    buf_action = np.zeros((T, B), np.int64)
    buf_logprob = np.zeros((T, B), np.float32)
    buf_reward = np.zeros((T, B), np.float32)
    buf_done = np.zeros((T, B), np.float32)
    buf_value = np.zeros((T, B), np.float32)
    boot_state = np.zeros((B, n_rows, feat_dim), np.float32)
    keys: List[Optional[bytes]] = [None] * B
    no_act = [False] * B
    t_run = time.perf_counter()
    agent_seconds = 0.0

    try:
        for update in range(cfg.num_updates):
            for t in range(T):
                for b, env in enumerate(envs):
                    env.write_obs(buf_state[t, b], buf_mask[t, b])
                t0 = time.perf_counter()
                action, logprob, value = sample_action(
                    agent, gen, torch.from_numpy(buf_state[t]).to(device),
                    torch.from_numpy(buf_mask[t]).to(device))
                # one read-back of the step's actions, log-probs, values
                back = torch.stack([action.to(torch.float32), logprob,
                                    value]).cpu().numpy()
                agent_seconds += time.perf_counter() - t0
                action = back[0].astype(np.int64)
                buf_action[t] = action
                buf_logprob[t] = back[1]
                buf_value[t] = back[2]

                # apply every env's action first, so this step's measurements
                # can be served as one batch through the shared memo
                for b, env in enumerate(envs):
                    env_mask = buf_mask[t, b, :env.num_actions]
                    no_act[b] = env_mask.sum() == 0
                    if no_act[b]:
                        keys[b] = None
                        continue
                    a = int(action[b])
                    if a >= env.num_actions or env_mask[a] == 0:
                        a = int(np.argmax(env_mask))  # defensive fallback
                    keys[b] = env.begin_step(a)

                seen = set()
                owners = []          # first env to request each distinct miss
                for b, kb in enumerate(keys):
                    if kb is not None and kb not in seen:
                        seen.add(kb)
                        owners.append(b)
                if pool is not None and len(owners) > 1:
                    list(pool.map(lambda b: envs[b].prime_measure(), owners))
                elif batch_timer is not None and len(owners) > 1:
                    cycles = batch_timer.time_many(
                        [envs[b].id_at for b in owners])
                    for b, c in zip(owners, cycles):
                        envs[b].publish_measure(c)
                else:
                    for b in owners:
                        envs[b].prime_measure()

                for b, env in enumerate(envs):
                    if no_act[b]:
                        # "no actions available -> episode terminated" (§3.5)
                        reward, done = 0.0, True
                    else:
                        _, reward, done, _ = env.finish_step(want_obs=False)
                    ep_returns[b] += reward
                    buf_reward[t, b] = reward
                    buf_done[t, b] = float(done)
                    if done:
                        finished_returns.append(ep_returns[b])
                        ep_returns[b] = 0.0
                        env.reset()
                global_step += B

            for b, env in enumerate(envs):
                env.write_obs(boot_state[b])
            t0 = time.perf_counter()
            last_value = bootstrap_value(
                agent, torch.from_numpy(boot_state).to(device)).cpu().numpy()
            agent_seconds += time.perf_counter() - t0
            adv, ret = compute_gae(buf_reward, buf_value, buf_done,
                                   last_value, cfg.gamma, cfg.gae_lambda)
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in (
                         ("state", buf_state.reshape(T * B, n_rows,
                                                     feat_dim)),
                         ("mask", buf_mask.reshape(T * B, num_actions)),
                         ("action", buf_action.reshape(T * B)),
                         ("logprob", buf_logprob.reshape(T * B)),
                         ("adv", adv.reshape(T * B)),
                         ("ret", ret.reshape(T * B)),
                         ("value", buf_value.reshape(T * B)))}
            perms = torch.stack([
                torch.randperm(T * B, generator=gen, device=device)
                for _ in range(cfg.update_epochs)])
            opt_state, ustats = update_fn(agent, opt_state, batch, perms)
            ustats = type(ustats)(*torch.stack(list(ustats)).tolist())
            agent_seconds += time.perf_counter() - t0

            if update % log_every == 0:
                recent = finished_returns[-10 * cfg.num_envs:]
                measure_calls = sum(e.measure_calls for e in envs)
                memo_hits = sum(e.memo_hits for e in envs)
                wall = time.perf_counter() - t_run
                row = {
                    "update": update,
                    "global_step": global_step,
                    "episodic_return": float(np.mean(recent)) if recent else 0.0,
                    "approx_kl": ustats.approx_kl,
                    "entropy": ustats.entropy,
                    "policy_loss": ustats.policy_loss,
                    "value_loss": ustats.value_loss,
                    "clip_frac": ustats.clip_frac,
                    "best_cycles": min(env.best_cycles for env in envs),
                    # reward-loop memo totals (cumulative across the run)
                    "measure_calls": measure_calls,
                    "memo_hits": memo_hits,
                    "memo_misses": sum(e.memo_misses for e in envs),
                    "memo_hit_rate": memo_hits / max(measure_calls, 1),
                    # the run's wall time so far, split (module note)
                    "agent_seconds": agent_seconds,
                    "env_seconds": wall - agent_seconds,
                    "time": time.time(),
                }
                stats.append(row)
                if verbose:
                    print(f"[game] upd={update} step={global_step} "
                          f"ret={row['episodic_return']:.3f} "
                          f"kl={row['approx_kl']:.4f} ent={row['entropy']:.3f} "
                          f"best={row['best_cycles']:.0f} "
                          f"memo={row['memo_hit_rate']:.2f}")

    finally:
        # release measurement workers even when an update raises
        if pool is not None:
            pool.shutdown(wait=True)
    best_env = min(envs, key=lambda e: e.best_cycles)
    return GameResult(
        best_program=[ins.copy() for ins in best_env.best_program],
        best_cycles=best_env.best_cycles,
        baseline_cycles=envs[0].t0,
        agent=agent,
        stats=stats,
        config=cfg,
    )


def run_inference(program: Sequence[Instruction], agent: Agent,
                  stall_db: Optional[Dict[str, int]] = None,
                  episode_length: int = 32,
                  machine: Optional[Machine] = None) -> AssemblyGame:
    """Deterministic (greedy) inference replay on the agent's device —
    the paper's §5.7 mode for tracing the discovered optimization
    moves."""
    env = AssemblyGame(program, stall_db=stall_db, machine=machine,
                       episode_length=episode_length)
    obs = env.reset()
    for _ in range(episode_length):
        mask = obs["mask"]
        if mask.sum() == 0:
            break
        action, _ = greedy_action(
            agent, torch.from_numpy(obs["state"][None]).to(agent.device),
            torch.from_numpy(mask[None]).to(agent.device))
        a = int(action[0])
        if mask[a] == 0:
            a = int(np.argmax(mask))
        obs, _, done, _ = env.step(a)
        if done:
            break
    return env
