"""End-to-end driver: hyperparameter search over REAL transformer training,
on the PyTorch port.

Tunes (lr, weight_decay, warmup) of a llama-architecture model (SmolLM-135M
family) on the synthetic LM pipeline with ASHA early stopping, then reruns the
best config to convergence.  Reduced scale by default; ``--full`` uses the
real 135M config.  Trials train on ``--device`` (default ``cuda``, where
attention runs the CUDA flash-attention kernel; with no card it raises), or
on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/tune_transformer_torch.py [--full] [--samples 8]
    PYTHONPATH=src python examples/tune_transformer_torch.py --device cpu --samples 4
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import ASHAScheduler, loguniform, randint, run_experiments
from repro_torch.launch.tune import trial_model
from repro_torch.train.trainable import make_model_trainable


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="full 135M config")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--max-iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = cfg.reduced()
    trainable = make_model_trainable(
        trial_model(cfg, args.device), batch=8, seq_len=64, steps_per_iter=4,
        total_steps=args.max_iters * 4, device=args.device)

    space = {
        "lr": loguniform(3e-4, 3e-2),
        "weight_decay": loguniform(1e-3, 3e-1),
        "warmup": randint(2, 20),
    }
    analysis = run_experiments(
        trainable, space,
        scheduler=ASHAScheduler(metric="loss", mode="min",
                                max_t=args.max_iters, grace_period=3,
                                reduction_factor=3),
        num_samples=args.samples,
        stop={"training_iteration": args.max_iters},
        verbose=True,
    )
    print("\n== search results ==")
    for row in analysis.results_table():
        cfgs = {k: round(v, 5) if isinstance(v, float) else v
                for k, v in row["config"].items() if k != "model_cfg"}
        print(f"  {row['trial_id']}: iters={row['iterations']:2d} "
              f"best={row['best']:.4f} {cfgs}")
    best = analysis.best_config()
    print("\nbest:", {k: v for k, v in best.items() if k != "model_cfg"})

    print("\n== retraining best config to completion ==")
    tr = trainable(best)
    for i in range(args.max_iters * 2):
        m = tr.step()
        if i % 4 == 0:
            print(f"  iter {i:3d}: loss={m['loss']:.4f} acc={m['accuracy']:.3f} "
                  f"({m['steps_per_s']:.1f} steps/s)")
    print(f"final loss: {m['loss']:.4f}")


if __name__ == "__main__":
    main()
