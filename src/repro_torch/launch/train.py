"""Training launcher of the port (counterpart of ``repro/launch/train.py``),
one process:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
        --smoke --steps 20 [--data 2 --model 2]

Seeds the model from ``run.train.seed`` and runs the ``TrainLoop`` on the
synthetic data pipeline, printing the loss every ten steps. With ``--ckpt
DIR`` it resumes from the latest checkpoint in DIR, saves every
``checkpoint_every`` steps, stops on SIGTERM, and saves once more at the
end.

The mesh (JAX's rule): ``plan_remesh(n, --model)`` over n device slots,
training at ``fsdp_tp`` when the mesh has more than one slot, with
``act_batch_axes="data"`` and ``act_batch_extent`` the mesh's DATA. JAX
takes n from the visible devices and parses ``--data`` without reading
it; here n is the visible cards (or 1 for a named device such as
``--device cpu``), and ``--data D`` asks for ``D * --model`` slots instead
(``launch.mesh.make_host_mesh``: slot i on card i mod the cards, or every
slot on the named device, so slots may repeat a card). A checkpoint holds
whole tensors, so a run restarted with other ``--data`` / ``--model``
resumes on its new mesh. ``--coordinator`` and ``--num-hosts > 1`` are
refused (ROADMAP: multi-GPU): the port is one process, and several hosts
need ``torch.distributed``.
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
               "--num-hosts": args.num_hosts > 1}
    for flag, asked in refused.items():
        if asked:
            raise SystemExit(f"{flag} is not ported yet ({_MULTI})")
    return args


def mesh_for(args: argparse.Namespace):
    """(mesh or None, its (data, model) shape): JAX's ``plan_remesh`` over
    the device slots (the module docstring)."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.fault import plan_remesh
    named = args.device != "cuda"
    n = (args.data * args.model if args.data > 0 else
         1 if named else torch.cuda.device_count())
    shape = plan_remesh(n, args.model)
    if shape is None:
        raise SystemExit(f"cannot build a mesh from {n} device slots at "
                         f"TP={args.model}")
    if shape == (1, 1):
        return None, shape
    return make_host_mesh(*shape, device=args.device if named else None), \
        shape


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.train import TrainLoop

    run = get_config(args.arch)
    if args.smoke:
        run = run.smoke()
    mesh, shape = mesh_for(args)
    device = torch.device(args.device) if mesh is None else mesh.flat[0]
    print(f"[launch] slots={shape[0] * shape[1]} mesh={shape}"
          + (f" devices={[str(d) for d in mesh.flat]}" if mesh else ""),
          flush=True)
    model = build_model(run, ModelFlags(
        remat="none" if args.smoke else "full",
        act_batch_axes="data" if shape[0] * shape[1] > 1 else None,
        act_batch_extent=shape[0]))
    gen = torch.Generator(device=device).manual_seed(run.train.seed)
    loop = TrainLoop(model, run, model.init(gen, device), ckpt_dir=args.ckpt,
                     mesh=mesh)
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
