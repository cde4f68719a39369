"""Per-seed learning signal of the PPO agent, in either package.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ppo_learning_seeds.py \
        jax 0 12
    PYTHONPATH=src python tools/ppo_learning_seeds.py torch 0 12

Runs ``train_on_program`` at ``tests/test_ppo.py::
test_ppo_learns_on_kernel``'s config (2048 timesteps, 4 envs x 64 steps,
episodes of 48) on the rmsnorm listing at its first config, once per
seed in [FIRST, LAST), and prints each seed's best cycles and the
episodic return after each update.  The last-minus-first return over
these seeds is the input of the port's learning-signal bound (ROADMAP
§C).  The torch agent runs on the CPU.
"""

import sys


def main(pkg: str, first: int, last: int) -> None:
    if pkg == "jax":
        from repro.core import PPOConfig, build_stall_table, train_on_program
        from repro.kernels import KERNELS
        from repro.sched import lower, schedule
        kw = {}
    elif pkg == "torch":
        import torch
        from repro_torch.core import (PPOConfig, build_stall_table,
                                      train_on_program)
        from repro_torch.kernels import KERNELS
        from repro_torch.sched import lower, schedule
        torch.set_num_threads(1)
        kw = {"device": "cpu"}
    else:
        raise SystemExit(f"package must be 'jax' or 'torch', not {pkg!r}")
    k = KERNELS["rmsnorm"]
    program = schedule(lower(k.make_spec(k.configs[0])))
    stall_db = build_stall_table()
    gains = []
    for seed in range(first, last):
        cfg = PPOConfig(total_timesteps=2048, num_envs=4, num_steps=64,
                        episode_length=48, seed=seed)
        res = train_on_program(program, stall_db=stall_db, cfg=cfg, **kw)
        returns = [row["episodic_return"] for row in res.stats]
        gains.append(returns[-1] - returns[0])
        print(f"{pkg} seed {seed}: best {res.best_cycles:.0f} of "
              f"{res.baseline_cycles:.0f}; returns "
              f"{[round(r, 4) for r in returns]}; last - first "
              f"{gains[-1]:+.4f}", flush=True)
    print(f"{pkg}: last >= first at {sum(g >= 0 for g in gains)} of "
          f"{len(gains)} seeds; mean last - first {sum(gains) / len(gains):+.4f}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
