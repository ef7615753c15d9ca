#!/usr/bin/env python3
"""How far apart bf16 training gradients lie, whisper-tiny on one NVIDIA
GPU: through K5's autograd Function, plain autograd through K5's twin,
and an fp32 run.

Run from the repository root::

    python3 tools/grad_spread.py [--seeds 6]

For each seed ``i``, whisper-tiny at full width draws its weights from
seed ``20 + i`` and a batch of 8 × 448 tokens over 8 × 1500 frame
embeddings from seed ``800 + i`` (``chip_smoke.py`` phase 12 (a) draws
whisper's at ``i = 5``, its place in ``TRAIN_FAMILIES``), and takes the
first-step gradients of ``api.loss_fn``:

- through K5's Function as the port runs it (the backward's Δ is
  rowsum(P∘dP) in fp32, inside the loop where one 1024-key chunk holds
  every key, else from a pass ahead of it);
- the same with a chunk of one key fewer than the call has, which takes
  Δ from that pass;
- through plain autograd over the twin (``flash_attention_ref``);
- through the twin with fp32 compute (``g32``).

It prints, per seed, the tensors where the two K5 runs lie beyond
``chip_smoke.GRAD_REL`` of max|twin| from the twin's gradient, each
with both bf16 gradients' max|Δ| from g32 over max|g32|, and whether
``chip_smoke.py`` phase 12 (a)'s fp32 witness accepts it; then the
largest L2 distance between K5's and the twin's gradient and the range
of K5's L2 distance from g32 over the twin's.
"""
import argparse
import contextlib
import pathlib
import sys
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=6)
    args = parser.parse_args(argv)
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, layers

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this tool needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda")
    cfg = get_config("whisper-tiny")
    port_bwd = fa.flash_attention_bwd_ref

    def two_pass(q, k, v, lse, do, *, chunk, **kw):
        return port_bwd(q, k, v, lse, do,
                        chunk=min(chunk, k.shape[1] - 1), **kw)

    def twin_grad(q, k, v, *, chunk, **kw):
        del chunk
        return fa.flash_attention_ref(q, k, v, **kw)

    for seed in range(args.seeds):
        model = api.init_params(torch.Generator(dev).manual_seed(20 + seed),
                                cfg, device=dev)
        batch = cs.family_batch(torch, dev, cfg, 800 + seed, 8, 448)
        labels = torch.roll(batch["tokens"], -1, 1)
        labels[:, -1] = -1
        batch["labels"] = labels

        def grads(run_cfg, patch=None):
            model.zero_grad(set_to_none=True)
            model.cfg = run_cfg
            with patch or contextlib.nullcontext():
                api.loss_fn(model, batch, run_cfg).backward()
            model.cfg = cfg
            return {k: p.grad.clone() for k, p in model.named_parameters()}

        runs = {
            "K5": grads(cfg),
            "K5, Δ ahead of the loop": grads(cfg, mock.patch.object(
                fa, "flash_attention_bwd_ref", two_pass)),
            "twin": grads(cfg, mock.patch.object(
                layers, "flash_attention_grad", twin_grad)),
            "fp32": grads(cfg.scaled(compute_dtype="float32"),
                          mock.patch.object(layers, "flash_attention_grad",
                                            twin_grad)),
        }
        l2_apart, l2_ratio = 0.0, []
        for label in ("K5", "K5, Δ ahead of the loop"):
            beyond = []
            for name, g32 in runs["fp32"].items():
                s32 = cs.max_abs(torch, g32)
                if s32 == 0.0:
                    continue
                got, tw = runs[label][name], runs["twin"][name]
                apart = cs.max_abs(torch, got, tw) / cs.max_abs(torch, tw)
                e_fn = cs.max_abs(torch, got, g32) / s32
                e_tw = cs.max_abs(torch, tw, g32) / s32
                if label == "K5":
                    l2_apart = max(l2_apart, ((got - tw).norm()
                                              / tw.norm()).item())
                    l2_ratio.append(((got - g32).norm()
                                     / (tw - g32).norm()).item())
                if apart > cs.GRAD_REL:
                    ok = (max(e_fn, e_tw) > cs.GRAD_REL
                          and e_fn <= max(cs.WITNESS_RATIO * e_tw,
                                          cs.GRAD_REL))
                    beyond.append(f"{name} {apart:.4f} apart, K5 {e_fn:.4f}"
                                  f" and twin {e_tw:.4f} from g32, "
                                  f"{e_fn / e_tw:.2f}x, witness "
                                  f"{'ok' if ok else 'fails'}")
            cs.log(f"seed {seed}, {label}: {len(beyond)} tensors beyond "
                   f"{cs.GRAD_REL:g}*max|twin|" + "".join(
                       f"\n  {b}" for b in beyond))
        cs.log(f"seed {seed}: K5 and the twin at most {l2_apart:.4f} apart "
               f"in L2; K5's L2 distance from g32 {min(l2_ratio):.3f}-"
               f"{max(l2_ratio):.3f} times the twin's")
        del model, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
