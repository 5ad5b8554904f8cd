"""The shared body of the video examples: parse, warm up, generate, save."""

from __future__ import annotations

import numpy as np

from compactfusion_tpu_torch.args import FlexibleArgumentParser, xFuserArgs
from compactfusion_tpu_torch.utils.prof import Profiler


def run(argv, description: str, model: str, prefix: str, runner_cls, **defaults):
    """Parse ``argv`` (default: the command line) with ``model`` as the
    default model and ``defaults`` for the options left at their parser
    defaults, warm up, generate, save under ``results/``; returns (the video
    or latents, the saved path), (None, None) on a rank that holds none."""
    parser = FlexibleArgumentParser(description=description)
    xFuserArgs.add_cli_args(parser)
    args = xFuserArgs.from_cli_args(parser.parse_args(argv))
    if args.model == xFuserArgs.model:
        args.model = model
    for name, value in defaults.items():
        if getattr(args, name) == getattr(xFuserArgs, name):
            setattr(args, name, value)
    engine_config, input_config = args.create_config()

    runner = runner_cls(engine_config, input_config)
    Profiler.enable()
    with Profiler.scope("total"):
        with Profiler.scope("warmup"):
            runner()
        with Profiler.scope("generate"):
            out = runner()
    if out is None:
        print("output: none on this rank")
        return out, None
    arr = out.float().cpu().numpy()
    print(f"output: shape={arr.shape} finite={np.isfinite(arr).all()}")
    saved = runner.save("results", prefix=prefix, out=out)
    print(f"saved: {saved}")
    print(Profiler.summary())
    return out, saved
