"""The port's examples (``examples/*_torch.py``) run on the CPU at a small
size: ``serve_batch_torch.serve`` and ``pbt_population_torch.main`` called
with smaller sizes than their scripts' (which ``chip_smoke.py`` runs on the
card), ``tune_transformer_torch.py`` and ``vmap_sweep_torch.py`` through
their command lines with ``--device cpu`` and, for the tune driver, few
samples.  Each runs with one torch thread (``OMP_NUM_THREADS=1``), as
``tests/test_torch_tune.py::one_thread_workers`` starts its workers.

The served tokens are ``train/serve_step.py::generate``'s, on the same
weights, prompts and sampling seed (``tests/test_torch_serve.py`` holds
that path to JAX's); the PBT population clones parameters at least once.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import numpy as np  # noqa: F401
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.train.serve_step import generate

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_serve_batch_samples_generates_tokens(one_thread, arch, capsys):
    batch, prompt_len, new_tokens = 2, 8, 4
    got = example("serve_batch_torch").serve(arch, batch, prompt_len, new_tokens, device="cpu")
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = generate(params, cfg, prompts, new_tokens, temperature=0.8, seed=2)
    assert got.shape == (batch, new_tokens)
    assert torch.equal(got, want.to(got.dtype))
    assert f"generated ({batch}, {new_tokens})" in capsys.readouterr().out


def test_pbt_population_clones_parameters(one_thread):
    analysis, pbt = example("pbt_population_torch").main(
        device="cpu", num_samples=4, iterations=8, batch=4, seq_len=32)
    assert [t.status for t in analysis.trials] == ["TERMINATED"] * 4
    assert pbt.n_exploits >= 1
    assert any(t.scheduler_state.get("cloned_from") for t in analysis.trials)
    assert np.isfinite(analysis.best_value())


@pytest.mark.parametrize("script,args", [
    ("tune_transformer_torch.py", ["--device", "cpu", "--samples", "2", "--max-iters", "3"]),
    ("vmap_sweep_torch.py", ["--device", "cpu"]),
])
def test_example_script_runs_on_the_cpu(script, args):
    proc = subprocess.run([sys.executable, str(EXAMPLES / script), *args], capture_output=True,
                          text=True, env=ENV, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip()


def test_the_scripts_ask_for_the_card_by_default():
    """Without ``--device`` each script runs on ``cuda``, through
    ``resolve_device``: with no card here, it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = subprocess.run([sys.executable, str(EXAMPLES / "serve_batch_torch.py")],
                          capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr
