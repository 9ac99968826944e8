"""Batched serving with a KV cache, on the PyTorch port: prefill a batch of
prompts, then decode — runs gemma-2b (reduced) and rwkv6 (reduced,
O(1)-state) side by side.  The counterpart of ``examples/serve_batch.py``.
Serves on ``--device`` (default ``cuda``, where the prefill runs the CUDA
flash-attention and RWKV-6 scan kernels; with no card it raises), or on the
CPU with ``--device cpu``.  The sampled tokens are torch's from the same
seeds, not JAX's.

    PYTHONPATH=src python examples/serve_batch_torch.py
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.tune import trial_model
from repro_torch.models import decode_step, init_params, param_count, prefill
from repro_torch.train.serve_step import sample_tokens


@torch.no_grad()
def serve(arch: str, batch=2, prompt_len=32, new_tokens=12, device="cuda"):
    dev = resolve_device(device)
    cfg = trial_model(get_config(arch).reduced(), dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.time()
    logits, caches = prefill(params, {"tokens": prompts}, cfg,
                             max_len=prompt_len + new_tokens)
    gen = torch.Generator(device=dev).manual_seed(2)
    tok = sample_tokens(logits, gen, temperature=0.8)
    out = [tok]
    for i in range(new_tokens - 1):
        logits, caches = decode_step(params, caches, tok, prompt_len + i, cfg)
        tok = sample_tokens(logits, gen, 0.8)
        out.append(tok)
    tokens = torch.stack(out, dim=1).cpu()
    wall = time.time() - t0
    state_desc = ("recurrent state (O(1) in context)" if cfg.family == "ssm"
                  else f"KV cache (cap {prompt_len + new_tokens})")
    print(f"{arch:24s} {param_count(params):>9,} params  {state_desc}")
    print(f"  generated {tuple(tokens.shape)} in {wall:.1f}s; row0: {tokens[0].tolist()}")
    return tokens


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve("gemma-2b", device=args.device)
    serve("rwkv6-1.6b", device=args.device)
