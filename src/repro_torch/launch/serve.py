"""Batched serving driver: prefill a batch of prompts, decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --batch 8 --prompt-len 512 --new-tokens 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu

Counterpart of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``; with no card it raises).  Serves every family that
decodes: dense, MoE (``granite-moe-3b-a800m``, ``deepseek-moe-16b``), SSM
(``rwkv6-1.6b``), hybrid (``recurrentgemma-9b``) and VLM
(``paligemma-3b``), whose prompt is an image prefix of
``n_prefix_embeds`` patch embeddings followed by ``--prompt-len`` text
tokens; an encoder-only config (``hubert-xlarge``) is refused, as JAX's
command line refuses it.  Prefill runs the CUDA kernels:
flash attention (``attn_impl="pallas"``) and the RWKV-6 and RG-LRU scans
(``kernel_impl="pallas"``); decode (one token per step) runs the plain
attention and the single-step recurrences.  Every MoE layer routes through
the CUDA router kernel (``kernel_impl="pallas"``) in prefill and in decode.
Weights and prompts are random, from fixed seeds; the weights are drawn on
the serving device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, list_archs
from ..models import LM, ModelConfig, decode_step, init_params, param_count, prefill
from ..train.serve_step import sample_tokens


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    params: LM
    prompts: torch.Tensor          # (B, S) text tokens
    inputs: Dict[str, torch.Tensor]  # the prefill batch: the prompts, and a VLM's image prefix
    prefix: int                    # positions before the text (a VLM's image patches)
    tokens: torch.Tensor           # (B, new_tokens) generated
    prefill_logits: torch.Tensor   # (B, V)
    step_logits: List[torch.Tensor]  # decode step i's logits (B, V), i < new_tokens-1
    caches: List[Any]              # after the last decode step
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, batch: int, prompt_len: int, new_tokens: int,
          temperature: float = 0.0, device="cuda") -> ServeResult:
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.arch_id} is encoder-only: no decode")
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, attn_impl="pallas", kernel_impl="pallas")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    B, S = batch, prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    inputs, P = {"tokens": prompts}, 0
    if cfg.frontend == "vision_stub":
        # the image prefix, drawn as ``synthetic_batch`` draws it with seed 1
        P = cfg.n_prefix_embeds
        patches = np.random.default_rng(1).standard_normal((B, P, cfg.frontend_dim))
        inputs["patch_embeds"] = torch.from_numpy(patches.astype(np.float32)).to(dev)
    max_len = P + S + new_tokens

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, inputs, cfg, max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    gen = torch.Generator(device=dev).manual_seed(2)
    tok = sample_tokens(logits, gen, temperature)
    out, step_logits = [tok], []
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, caches = decode_step(params, caches, tok, P + S + i, cfg)
        tok = sample_tokens(logits, gen, temperature)
        step_logits.append(logits)
        out.append(tok)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return ServeResult(cfg, params, prompts, inputs, P, torch.stack(out, dim=1),
                       prefill_logits, step_logits, caches, t_prefill, t_dec)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = serve(cfg, args.batch, args.prompt_len, args.new_tokens,
                args.temperature, args.device)
    B, S = args.batch, res.prefix + args.prompt_len
    prompt = f"{S}" if not res.prefix else f"({res.prefix}+{args.prompt_len})"
    print(f"[serve] {cfg.arch_id}: {param_count(res.params):,} params")
    print(f"[serve] prefill {B}x{prompt}: {res.prefill_s:.2f}s "
          f"({B*S/res.prefill_s:.0f} tok/s)")
    print(f"[serve] decode {args.new_tokens} steps: {res.decode_s:.2f}s "
          f"({B*(args.new_tokens-1)/max(res.decode_s, 1e-9):.0f} tok/s)")
    print(f"[serve] sample output tokens (row 0): {res.tokens[0][:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
