"""The CartPole fixture script (counterpart of ``cartpole-test.py``): the
learners on the CartPole env with the reference's retuned flags, which
separates algorithm bugs from simulator bugs.

    python -m traffic_env_tpu_torch.cartpole_test --trainer=qlearn \\
        [--platform=cpu] [--num_envs=...] [--total_episodes=...]

The overrides below are applied after the command line, as there: the
flags they name take these values whatever the command line says.  Runs
on the CUDA card unless ``--platform=cpu`` is given.
"""

from .algorithms import run_alg
from .config import parse_flags


def main(argv=None):
    cfg = parse_flags(argv)
    cfg = cfg.replace(
        env_name="cartpole",
        learning_rate=0.1,
        episode_len=800,
        gamma=0.99,
        summary_rate=20,
        save_rate=10000,
        train_rate=1,
        batch_size=10,
        target_update_rate=5,
        annealing_episodes=1000,
        buffer_size=50,
        lam=1.0,
        start_eps=0.2,
        trace_size=1,
        validate_rate=20,
        print_discounted=False,
    ).derive()
    return run_alg(cfg)


if __name__ == "__main__":
    main()
