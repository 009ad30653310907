"""Serving launcher, ported from ``repro.launch.serve``: batched decoding
against the KV caches, greedy by default.

    # on the card, Qwen3-0.6B at its published width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --full --batch 4 --prompt-len 32 --gen 32

    # on the CPU, at the reduced size
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Sampling at ``--temperature`` > 0 is a Gumbel-max draw from a
``torch.Generator``; the JAX package's ``jax.random.categorical`` draws
cannot be reproduced, so sampled ids differ from its ones (greedy ids do
not).
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.transformer import Model


def _pick(logits: torch.Tensor, temperature: float,
          generator: torch.Generator | None) -> torch.Tensor:
    """(B,) next ids: the argmax of ``logits`` (B, V), or at a temperature
    a Gumbel-max draw from ``generator``."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device).clamp_min_(
                       torch.finfo(torch.float32).tiny)
    return (logits.float() / temperature
            - torch.log(-torch.log(u))).argmax(dim=-1)


def generate(model: Model, params: dict, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """prompts: (B, P) token ids on the parameters' device -> (B, P + gen)
    ids.  The prompt goes through ``Model.prefill`` (a loop of decode
    steps, exactly the token-by-token loop), then one ``decode_step`` a new
    token; the logits after the last token are not needed and not
    computed.  ``generator`` draws the samples at a temperature (seed 0 on
    the prompts' device if not given)."""
    cfg = model.cfg
    b, p_len = prompts.shape
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=prompts.device).manual_seed(0)
    caches = model.init_cache(b, p_len + gen, device=prompts.device)
    out = [prompts]
    with torch.no_grad():
        logits, caches = model.prefill(params, prompts, caches)
        for t in range(p_len, p_len + gen):
            cur = _pick(logits[:, 0, :cfg.vocab_size], temperature,
                        generator)[:, None].to(prompts.dtype)
            out.append(cur)
            if t < p_len + gen - 1:
                logits, caches = model.decode_step(params, cur, t, caches)
    return torch.cat(out, dim=1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap


def main(argv: Any = None) -> torch.Tensor:
    """Random weights (``--seed``) and random prompts (``--seed`` + 1);
    prints the rate and the last ids of the first sequence and returns
    every sequence's ids."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} has an embeddings frontend; serve "
                         "demo supports token models")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.gen,
                   temperature=args.temperature, generator=gen)
    ids = out.cpu()
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    print(f"[serve] {args.arch}: generated {n_new} tokens in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s, batch {args.batch})")
    print("sample ids:", ids[0, -16:].tolist())
    return ids


if __name__ == "__main__":
    main()
