"""Training launcher of the port (counterpart of ``repro/launch/train.py``),
one process on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
        --smoke --steps 20

Seeds the model from ``run.train.seed`` on the device and runs the
``TrainLoop`` on the synthetic data pipeline, printing the loss every ten
steps. With ``--ckpt DIR`` it resumes from the latest checkpoint in DIR,
saves every ``checkpoint_every`` steps, stops on SIGTERM, and saves once
more at the end. The multi-host and mesh options are not ported yet and
are refused (ROADMAP: multi-GPU).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

_MULTI = "ROADMAP: multi-GPU"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel degree")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel degree")
    args = ap.parse_args(argv)
    refused = {"--coordinator": args.coordinator is not None,
               "--num-hosts": args.num_hosts > 1,
               "--data": args.data > 1, "--model": args.model > 1}
    for flag, asked in refused.items():
        if asked:
            raise SystemExit(f"{flag} is not ported yet ({_MULTI})")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.train import TrainLoop

    run = get_config(args.arch)
    if args.smoke:
        run = run.smoke()
    device = torch.device(args.device)
    model = build_model(run, ModelFlags(remat="none" if args.smoke
                                        else "full"))
    gen = torch.Generator(device=device).manual_seed(run.train.seed)
    loop = TrainLoop(model, run, model.init(gen, device), ckpt_dir=args.ckpt)
    loop.guard.install()
    try:
        if loop.try_restore():
            print(f"[launch] restored step {loop.step}", flush=True)
        steps = args.steps if args.steps is not None else run.train.steps
        print(f"[launch] {run.model.name} on {device}: "
              f"{run.model.param_count() / 1e6:.1f} M params, {steps} steps "
              f"of {run.train.global_batch}x{run.train.seq_len}", flush=True)
        while loop.step < steps and not loop.guard.should_save():
            stats = loop.run_steps(min(10, steps - loop.step))
            print(f"[train] step={loop.step} loss={stats['loss']:.4f} "
                  f"lr={stats['lr']:.2e} {stats['step_time'] * 1e3:.0f}ms "
                  f"stragglers={loop.monitor.stragglers()}", flush=True)
        if args.ckpt:
            loop.save()
            loop.ckpt.wait()
    finally:
        loop.guard.uninstall()


if __name__ == "__main__":
    main()
