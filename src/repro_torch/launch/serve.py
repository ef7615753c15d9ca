"""Serving launcher: batched autoregressive greedy decode on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --batch 4 --prompt-len 16 --gen 16

The loop of ``repro.launch.serve.generate``: a prompt drawn by numpy
from ``seed``, prefill through teacher-forced decode steps, then greedy
argmax (always argmax for a config with ``serve_sample``, whose serve
step returns the argmax tokens in the reference). The audio family
first encodes zero frames and puts each decoder layer's cross K/V in the
cache. Every step goes through ``train_step.make_serve_step`` on
``make_mesh_for`` the card count (``(1, 1)`` with one card or on the
CPU), as the reference's loop does, every position on the model's
device (``launch.train.mesh_on``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import checked_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import mesh_on
from repro_torch.models import api
from repro_torch.train import train_step as ts


def generate(cfg, batch: int, prompt_len: int, gen: int, max_len: int = 0,
             greedy: bool = True, seed: int = 0, *, params=None,
             device="cuda"):
    """Prefill via teacher-forced decode steps, then generate ``gen`` tokens.

    ``params`` is a model from :func:`repro_torch.models.api.init_params`
    (or :mod:`repro_torch.models.convert`); without one, weights are drawn
    from a generator seeded with 0 on ``device``. Returns the generated
    tokens (batch, gen) and the seconds the decode loop took, ending in a
    device synchronisation.
    """
    dev = checked_device(device, "generate")
    max_len = max_len or (prompt_len + gen)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    if params is None:
        params = api.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                 device=dev)
    cache = api.init_cache(cfg, batch, max_len, dtype=torch.float32,
                           device=dev)
    if cfg.family == "audio":
        frame = torch.zeros((batch, cfg.n_audio_ctx, cfg.d_model),
                            dtype=torch.float32, device=dev)
        with torch.no_grad():
            xk, xv = params.enc_kv(params.encode(frame))
        cache["xk"] = xk.to(cache["xk"].dtype)
        cache["xv"] = xv.to(cache["xv"].dtype)
    serve_step = ts.make_serve_step(cfg, mesh_on(dev))
    toks = torch.from_numpy(prompt).to(dev)
    out_tokens = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(prompt_len + gen - 1):
            tok = toks[:, t:t + 1] if t < prompt_len else out_tokens[-1]
            lg, cache = serve_step(params, cache, tok, t + 1)
            if t >= prompt_len - 1:
                if cfg.serve_sample:
                    nxt = lg  # the serve step returned the argmax tokens
                elif greedy:
                    nxt = torch.argmax(lg[:, -1], dim=-1).to(
                        torch.int32)[:, None]
                else:
                    nxt = torch.from_numpy(rng.integers(
                        0, cfg.vocab, (batch, 1)).astype(np.int32)).to(dev)
                out_tokens.append(nxt)
    gen_arr = torch.cat(out_tokens, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    return gen_arr, dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    toks, dt = generate(cfg, args.batch, args.prompt_len, args.gen)
    n = toks.shape[0] * toks.shape[1]
    print(f"[serve] generated {toks.shape} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s); sample: {toks[0][:8].tolist()}")


if __name__ == "__main__":
    main()
