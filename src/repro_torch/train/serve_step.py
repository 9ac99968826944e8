"""Serving steps: batched prefill and single-token decode, plus a simple
batched greedy/temperature sampler loop.  Counterpart of
``repro.train.serve_step``."""
from __future__ import annotations

from typing import Optional

import torch

from ..models import ModelConfig, decode_step, prefill

__all__ = ["make_prefill_step", "make_decode_step", "sample_tokens", "generate"]


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return prefill(params, batch, cfg, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def step(params, caches, tokens, pos):
        return decode_step(params, caches, tokens, pos, cfg)
    return step


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """Greedy (temperature 0) or categorical sampling. logits (B, V) -> (B,).

    ``generator`` must live on the logits' device; it gives other numbers
    than ``jax.random`` from the same seed."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def generate(params, cfg: ModelConfig, prompt_tokens: torch.Tensor, n_new: int,
             temperature: float = 0.0, seed: int = 0,
             max_len: Optional[int] = None) -> torch.Tensor:
    """End-to-end batched generation (prefill + decode loop). Returns (B, n_new)
    on the prompt's device."""
    B, S = prompt_tokens.shape
    max_len = max_len or (S + n_new)
    logits, caches = prefill(params, {"tokens": prompt_tokens}, cfg, max_len)
    gen = torch.Generator(device=prompt_tokens.device).manual_seed(seed)
    tok = sample_tokens(logits, gen, temperature)
    out = [tok]
    for i in range(n_new - 1):
        logits, caches = decode_step(params, caches, tok, S + i, cfg)
        tok = sample_tokens(logits, gen, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
