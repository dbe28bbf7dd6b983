"""Batched LM serving: prefill a batch of prompts, decode continuations.

Uses the launcher's fixed-batch path (``launch/serve.py --legacy``:
one prefill, then one decode step per token against the cache, in place)
on the architecture's smoke config by default; pass ``--real`` for its
full config.  On the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --real     # smollm-135m, card
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--real", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)

    argv = ["--arch", args.arch, "--legacy", "--device", args.device,
            "--batch", str(args.batch), "--prompt-len", str(args.prompt_len),
            "--gen", str(args.gen), "--mesh", "1x1"]
    if not args.real:
        argv.append("--smoke")
    return serve.main(argv)


if __name__ == "__main__":
    main()
