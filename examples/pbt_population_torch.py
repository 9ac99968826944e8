"""Population-Based Training on a real model, on the PyTorch port: the
scheduler clones the best trial's *model parameters* mid-training and
perturbs its learning rate — the paper's §3 "clone or mutate model
parameters in the middle of training" requirement, exercised through the
narrow interface alone.  The counterpart of ``examples/pbt_population.py``.
Trials train on ``--device`` (default ``cuda``, where attention runs the
CUDA flash-attention kernel; with no card it raises), or on the CPU with
``--device cpu``.

    PYTHONPATH=src python examples/pbt_population_torch.py
    PYTHONPATH=src python examples/pbt_population_torch.py --device cpu
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import PopulationBasedTraining, loguniform, run_experiments
from repro_torch.launch.tune import trial_model
from repro_torch.train.trainable import make_model_trainable


def main(device="cuda", num_samples=6, iterations=16, batch=8, seq_len=64):
    cfg = trial_model(get_config("smollm-135m").reduced(), device)
    trainable = make_model_trainable(cfg, batch=batch, seq_len=seq_len,
                                     steps_per_iter=3, total_steps=60, device=device)
    pbt = PopulationBasedTraining(
        metric="loss", mode="min",
        perturbation_interval=4,
        hyperparam_mutations={"lr": loguniform(1e-4, 1e-1)},
        quantile_fraction=0.25,
        seed=0,
    )
    analysis = run_experiments(
        trainable,
        {"lr": loguniform(1e-5, 1e-1)},  # deliberately wide: some trials start badly
        scheduler=pbt,
        num_samples=num_samples,
        stop={"training_iteration": iterations},
        checkpoint_freq=1,
        verbose=True,
    )
    print(f"\nexploit/explore events: {pbt.n_exploits}")
    for t in analysis.trials:
        lr = t.config["lr"]
        cloned = t.scheduler_state.get("cloned_from", "-")
        print(f"  {t.trial_id}: final lr={lr:.5f} best={t.best_value('loss','min'):.4f} "
              f"cloned_from={cloned}")
    print("best loss:", round(analysis.best_value(), 4))
    return analysis, pbt


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
