"""Greedy tokens of full-size phi3-mini-3.8b in bf16 on the port's
kernels against the same model on the plain backend, on the card.

    python tools/tokens_vs_plain.py [ROOT ...]

For each ROOT (a checkout; default this one), whose ``src`` is imported
in a process of its own: random weights from seed 0, ``chip_smoke.py``'s
8 engine requests (32 new tokens) drained with captured graphs on the
``cuda`` backend and eagerly on ``plain``, and its left-padded
``generate`` batch of 4 on both.  The prompts' tokens are drawn from
each seed of ``PROMPT_SEEDS`` (1 is ``chip_smoke.py``'s; the generate
batch from the seed plus one), so one seed's share reads beside the
spread over the others.  Prints, per ROOT and seed, the
share of equal tokens, each request's first differing token (null:
none) and each generate row's count of equal tokens, then the card's
name and power limit.  Each kernel call is held to its plain version elsewhere
(``chip_smoke.py``'s ``[batched_vs_plain]``); this reads how far two
bf16 paths within that tolerance part over a 32-layer greedy decode.
Needs a CUDA card and ``nvcc``.
"""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROMPT_SEEDS = (1, 3, 5)

CHILD = r"""
import json, sys
root, seeds = sys.argv[1], json.loads(sys.argv[2])
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import build_model, left_pad_prompts, prompt_starts
from repro_torch.runtime import generate
_build.load()
dev = torch.device("cuda")
cfg = get_config("phi3-mini-3.8b")
model = build_model(cfg)
params = model.init(seed=0, device=dev)
for seed in seeds:
    prompts = cs.prompts_of(cs.ENGINE_PROMPTS, cfg.vocab_size, seed=seed)
    eng = {}
    for backend, capture in (("cuda", True), ("plain", False)):
        res, _ = cs.engine_run(torch, model, params, prompts, backend,
                               capture)
        eng[backend] = {k: v.tokens.tolist() for k, v in res.items()}
    gp = cs.prompts_of(cs.GENERATE_PROMPTS, cfg.vocab_size, seed=seed + 1)
    batch = {"tokens": left_pad_prompts(gp, 512)}
    gen = {b: generate(model, params, batch, max_new_tokens=cs.NEW_TOKENS,
                       seq_starts=prompt_starts(gp, 512),
                       backend=b)[0].tolist() for b in ("cuda", "plain")}
    ids = sorted(eng["cuda"])
    pairs = [(eng["cuda"][r][i], eng["plain"][r][i]) for r in ids
             for i in range(cs.NEW_TOKENS)]
    print(json.dumps({
        "root": root, "prompt_seed": seed,
        "engine_equal_share": sum(a == b for a, b in pairs) / len(pairs),
        "engine_first_diff": {
            r: next((i for i in range(cs.NEW_TOKENS)
                     if eng["cuda"][r][i] != eng["plain"][r][i]), None)
            for r in ids},
        "generate_equal_per_row": [
            sum(a == b for a, b in zip(x, y))
            for x, y in zip(gen["cuda"], gen["plain"])]}), flush=True)
"""


def main(argv=None):
    roots = (argv if argv is not None else sys.argv[1:]) or [str(REPO)]
    for root in roots:
        out = subprocess.run([sys.executable, "-c", CHILD,
                              str(Path(root).resolve()),
                              json.dumps(PROMPT_SEEDS)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"tokens_vs_plain: {root} failed\n"
                             + out.stderr[-4000:])
        for line in out.stdout.strip().splitlines():
            if line.startswith("{"):
                print(line, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
