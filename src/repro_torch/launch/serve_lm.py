"""Serving example: batched prefill and greedy decode with KV caches
(the port's counterpart of the JAX package's ``examples/serve_lm.py``).

Works with every registered architecture, full size or ``-smoke``
(attention, moe, ssm, hybrid, vlm, audio).  The prompt tokens are drawn
from a numpy generator seeded 1, the vlm ``image_embeds`` or the audio
``frames`` from one seeded 2, the weights from ``Model.init(seed=0)``.
Runs on the CUDA card through the hand-written kernels unless
``--device cpu`` (where each kernel wrapper runs its plain version);
with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]
      PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
          --arch falcon-mamba-7b-smoke --device cpu
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import ServeStats, generate


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int
               ) -> Dict[str, np.ndarray]:
    """Random prompts [batch, prompt_len] (numpy seed 1), with the
    family's modality field (seed 2): ``image_embeds`` for vlm,
    ``frames`` for audio, float32."""
    out: Dict[str, np.ndarray] = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)}
    rng = np.random.default_rng(2)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def run(model, params, batch: Dict[str, Any], new_tokens: int,
        backend: str = "cuda") -> Tuple[np.ndarray, ServeStats]:
    """Generate ``new_tokens`` greedy tokens for every row of ``batch``
    with ``params`` (their device is the run's) and print the example's
    three lines; returns (tokens, stats)."""
    out, stats = generate(model, params, batch, max_new_tokens=new_tokens,
                          backend=backend)
    print(f"arch={model.cfg.name} generated {out.shape} tokens")
    print(f"prefill {stats.prefill_s*1e3:.1f}ms, decode "
          f"{stats.decode_s*1e3:.1f}ms "
          f"({stats.decode_tok_s:.0f} tok/s)")
    print("sample:", out[0][:16].tolist(), flush=True)
    return out, stats


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[np.ndarray, ServeStats]:
    """Parse the flags, build the model on the device, serve one batch."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="'cpu' serves on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(seed=0, device=resolve_device(args.device))
    return run(model, params, make_batch(cfg, args.batch, args.prompt_len),
               args.new_tokens)


if __name__ == "__main__":
    main()
