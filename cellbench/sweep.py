"""Find the serving knee once, on the card: one engine of a serving cell,
fed its traffic at each offered rate in turn for ``--seconds``, drained
between rates:

  python3 -m cellbench.sweep --workload <cell> --rates 2,4,6,8,30 --seconds 20

One JSON line a rate: the tokens a second served in the window against
those offered (the rate times a request's mean prompt and output), and
the median, 90th and 95th percentile of the time to first token.  The
knee is the highest rate whose served tokens keep up with the offered
ones while the first-token times stay flat; a cell below it offers about
four fifths of it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

from cellbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import numpy as np
    import torch

    from cellbench import program, traffic
    from cellbench.drivers import lm_serve
    from cellbench.trace import Tracer

    found = harness.load_cell(args.workload)
    ctx = harness.Context(seed=args.seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0), t_start=time.perf_counter(),
                          tracer=Tracer(False), **found)
    engine = lm_serve._engine(ctx, program.lm_params(ctx.cfg, ctx.seed, ctx.device))
    engine.warmup()
    block = list(itertools.islice(traffic.arrivals(ctx.mix, args.seed), int(ctx.mix["block"])))
    per_request = sum(a.prompt_len + a.max_new for a in block) / len(block)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(ctx.mix, rate_per_s=rate)
        loop, window_s, ttft, failed, sent = lm_serve.serve_window(ctx, engine, mix)
        while engine.queue or engine.kv.owner:  # drain before the next rate
            engine.step()
        print(json.dumps({
            "rate": rate, "sent": sent, "failed": failed, "window_s": window_s,
            "tokens_per_s": loop.tokens / window_s, "offered_tokens_per_s": rate * per_request,
            **{f"ttft_p{q}_ms": 1e3 * float(np.percentile(ttft, q)) for q in (50, 90, 95)},
            "decode_ms_median": 1e3 * float(np.median(loop.decode_s)) if loop.decode_s else None,
            "rows_mean": float(np.mean(loop.decode_rows)) if loop.decode_rows else None,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
