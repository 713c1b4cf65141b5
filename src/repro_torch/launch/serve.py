"""Serving launcher of the port (counterpart of ``repro/launch/serve.py``):
continuous batching over ``ServingEngine`` with SpecEE as the default
strategy, one process on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --ci
    python -m repro_torch.launch.serve --arch llama2-13b --requests 16

``--smoke`` serves the arch's smoke config; without it the published size,
seeded (weights and SpecEE bundle from seeds 0 and 1 on the device; with
shard slots, on the host, which keeps the one whole tree).
``--trained`` trains the bundle first with the port's own offline training
(``repro_torch.core.bundle``, in ``benchmarks/common.py::get_bundle``'s
order, on get_bundle's config: the smoke config deepened to 12 layers).
Prompts are a pure function of the command line (numpy seed 0), 4 to 15
tokens each, so a restarted ``--restore`` run serves the same workload.

Fault tolerance:
    --checkpoint-dir D   arm SIGTERM preemption: the engine drains, saves a
                         step-atomic snapshot into D and the process exits
                         with code 17 (the guard is installed before the
                         model is built)
    --restore            resume the latest snapshot in D token-identically
    --inject SITE        deterministic fault injection at one site
                         (dispatch, finish_timeout, nan_logits,
                         pool_exhausted, sigterm); the run must still
                         complete every request. ``sigterm`` recovers in
                         the same process. ``device_lost`` needs a
                         tensor-parallel mesh and is refused
    --fault-log PATH     write the engine's FaultEvent ring to PATH as
                         JSONL after the run
    --num-pages N        a paged pool smaller than the batch's rows need:
                         the engine evicts under pool pressure

``--ci`` caps the run at 4 requests of 6 new tokens and asserts that every
request completes with its budget, that every page is freed, and that the
tokens equal those of an in-process reference: the engine on the plain
paths (no kernel, the unfused gate), per tick, same admission and weights,
on a full pool and with no fault.

Multi-GPU serving:
    --mesh 1,N           tensor-parallel decode over N shards
                         (``launch.mesh``); DATA must be 1, as JAX's
                         launcher requires (``Engine.create(mesh=)`` and
                         ``ServingEngine(mesh=)`` take a (D, P) mesh with
                         D > 1 from code: ``policy="tp_dp"|"tp2d"|
                         "fsdp_tp"``)
    --replicas M         M engines behind one queue (``ReplicaPool``)
    --inject device_lost the engine drops its highest device and remeshes
                         in place (needs --mesh 1,N>1)

There are ``replicas × N`` shard slots, slot i on ``cuda:(i mod
device_count)`` (all on ``--device`` when it names one, such as ``cpu``
or ``cuda:1``): a machine with fewer cards
holds several shards on one card, and the launcher prints how many slots
share each card.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from typing import List, Optional

from repro_torch.runtime.faultinject import SITES

PREEMPTED_EXIT_CODE = 17


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (default: published size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--mode", default="specee",
                    choices=["specee", "dense", "tree"],
                    help="decode strategy behind the serving engine")
    ap.add_argument("--no-specee", action="store_true",
                    help="alias for --mode dense")
    ap.add_argument("--no-fused-gate", action="store_true",
                    help="pin the plain (unfused) exit-gate path")
    ap.add_argument("--cache", default="paged", choices=["paged", "dense"])
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged pool size in pages (default: every row's "
                         "pages; fewer oversubscribes the pool and drives "
                         "victim eviction)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill tokens per tick (0 = blocking)")
    ap.add_argument("--megatick", type=int, default=1)
    ap.add_argument("--sync-ticks", action="store_true",
                    help="no async pipeline even with --megatick > 1")
    ap.add_argument("--quant", default=None, choices=["int8", "int4"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for --mode dense (0 = "
                         "greedy)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the session's sampling seed")
    ap.add_argument("--trained", action="store_true",
                    help="train draft + predictors first")
    ap.add_argument("--ci", action="store_true",
                    help="few short requests + completion and parity "
                         "asserts")
    ap.add_argument("--ticks-per-check", type=int, default=1,
                    help="(reserved) serving ticks between health checks")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="arm SIGTERM preemption: drain + snapshot here, "
                         f"exit {PREEMPTED_EXIT_CODE}; restart with "
                         "--restore to resume")
    ap.add_argument("--restore", action="store_true",
                    help="resume the latest checkpoint in --checkpoint-dir "
                         "(a no-op on an empty directory)")
    ap.add_argument("--inject", default=None, choices=list(SITES),
                    help="inject one fault at the named site; the run must "
                         "still complete")
    ap.add_argument("--fault-log", default=None, metavar="PATH",
                    help="write the FaultEvent trail to PATH as JSONL after "
                         "the run")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL",
                    help="decode mesh shape; MODEL > 1 turns on tensor-"
                         "parallel decode; DATA must be 1 (Engine and "
                         "ServingEngine take a (DATA, MODEL) mesh with "
                         "DATA > 1 from code)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel ServingEngine replicas behind one "
                         "shared queue (ReplicaPool), each over its own "
                         "MODEL shard slots")
    args = ap.parse_args(argv)
    try:
        data_par, model_par = (int(x) for x in args.mesh.split(","))
    except ValueError:
        ap.error(f"--mesh must be DATA,MODEL ints, got {args.mesh!r}")
    if data_par != 1:
        ap.error("--mesh DATA must be 1: data parallelism is --replicas "
                 "(independent engines), not an in-engine mesh axis")
    if model_par < 1 or args.replicas < 1:
        ap.error("--mesh MODEL and --replicas must be >= 1")
    args.model_par = model_par
    if args.inject == "device_lost" and model_par <= 1:
        ap.error("--inject device_lost needs a tensor-parallel mesh to "
                 "degrade (e.g. --mesh 1,2): an unsharded engine has no "
                 "surviving devices to remesh onto and the fault is "
                 "terminal")
    if args.replicas > 1 and (args.checkpoint_dir or args.restore
                              or args.inject is not None):
        ap.error("--replicas composes with in-pool failover (a dead "
                 "replica's requests migrate to survivors), not with the "
                 "single-engine --checkpoint-dir/--restore/--inject paths")
    if args.no_specee:
        args.mode = "dense"
    if args.temperature > 0.0 and args.mode != "dense":
        ap.error("--temperature requires --mode dense (SpecEE verification "
                 "is argmax-defined)")
    if args.num_pages is not None and args.cache != "paged":
        ap.error("--num-pages requires --cache paged")
    if args.restore and not args.checkpoint_dir:
        ap.error("--restore requires --checkpoint-dir")
    if args.ci:
        args.requests = min(args.requests, 4)
        args.max_new = min(args.max_new, 6)
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    scratch = None
    if args.inject == "sigterm" and not args.checkpoint_dir:
        # the injected preemption recovers in this process, which needs
        # somewhere to put the checkpoint
        scratch = args.checkpoint_dir = tempfile.mkdtemp(prefix="serve-ckpt-")
    # arm SIGTERM before the heavy start (imports, weights): a preemption
    # landing during the build defers to the first serving tick, which
    # drains, saves and exits cleanly
    guard = None
    if args.checkpoint_dir:
        from repro_torch.runtime.fault import PreemptionGuard
        guard = PreemptionGuard()
        guard.install()
    try:
        _serve(args, guard)
    finally:
        if guard is not None:
            guard.uninstall()
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


def _serve(args: argparse.Namespace, guard) -> None:
    import numpy as np
    import torch

    from repro_torch.api import CacheSpec, DenseStrategy
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.launch.mesh import make_mesh, make_replica_meshes, slots
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.runtime import faultinject
    from repro_torch.runtime.faultinject import FaultSchedule
    from repro_torch.serving import Preempted, ServingEngine
    from repro_torch.sharding.serving import unplace

    device = torch.device(args.device)
    # replicas x MODEL shard slots, slot i on cuda:(i mod device_count);
    # a named device (cpu, cuda:1) holds them all
    named = device.type != "cuda" or device.index is not None
    meshes = make_replica_meshes(args.replicas, args.model_par,
                                 device=device if named else None)
    # with meshes the one whole tree lives on the host: every engine cuts
    # its slots' copies from it (and a remesh its new ones), so no card
    # holds it whole
    hosted = any(ms is not None for ms in meshes)
    home = torch.device("cpu") if hosted else device
    if args.trained:
        from repro_torch.core.bundle import bundle_run, train_bundle
        run = bundle_run(args.arch)
        t0 = time.perf_counter()
        params, sw, _ = train_bundle(run, device, 32)
        params, sw = unplace(params, home), unplace(sw, home)
        print(f"[serve] trained a bundle for {run.model.name} "
              f"({run.model.num_layers} layers) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    else:
        run = get_config(args.arch)
        if args.smoke:
            run = run.smoke()
        params = build_model(run).init(
            torch.Generator(device=home).manual_seed(0), home)
        sw = eng.init_specee(build_model(run),
                             torch.Generator(device=home).manual_seed(1),
                             home)
    # the card runs every kernel of the path; the CPU their plain versions
    flags = ModelFlags(flash_attention=True, decode_kernel=True,
                       spec_head_kernel=True, exit_gate_impl="kernel")
    model = build_model(run, flags)
    strategy = args.mode
    if args.temperature > 0.0:
        strategy = DenseStrategy(temperature=args.temperature)
    cache = args.cache
    if args.num_pages is not None:
        cache = CacheSpec(kind="paged",
                          page_size=args.page_size or run.serve.page_size,
                          num_pages=args.num_pages)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, run.model.vocab_size, int(rng.integers(4, 16)))
               for _ in range(args.requests)]

    ref_mesh = (make_mesh(slots(1, device if named else None), 1, 1)
                if hosted else None)

    def make_engine(m, megatick, async_ticks, fused_gate, cache,
                    checkpoint_dir=None, mesh=None):
        return ServingEngine(m, params, sw, strategy=strategy,
                             prng_seed=args.seed, fused_gate=fused_gate,
                             cache=cache, page_size=args.page_size,
                             prefill_chunk=args.prefill_chunk,
                             megatick=megatick, async_ticks=async_ticks,
                             checkpoint_dir=checkpoint_dir,
                             guard=guard if checkpoint_dir else None,
                             quant=args.quant, mesh=mesh)

    def reference():
        """The plain paths, per tick, the same admission, a full pool, no
        fault, unsharded (on the first slot's device)."""
        ref = make_engine(build_model(run, ModelFlags()), 1, False, False,
                          args.cache, mesh=ref_mesh)
        for p in prompts:
            ref.submit(p, max_new_tokens=args.max_new)
        ref.run_to_completion()
        return {r.uid: r.output for r in ref.completed}

    placed = [d for ms in meshes if ms is not None for d in ms.flat]
    if placed:
        share = {str(d): placed.count(d) for d in dict.fromkeys(placed)}
        print(f"[serve] {len(placed)} shard slots over {len(share)} "
              f"device(s): {share} slots per device", flush=True)
    if args.replicas > 1:
        _serve_pool(args, prompts, meshes, make_engine, model, cache,
                    reference)
        return

    def run_engine(restore: bool):
        engine = make_engine(model, args.megatick,
                             False if args.sync_ticks else None,
                             not args.no_fused_gate, cache,
                             checkpoint_dir=args.checkpoint_dir,
                             mesh=meshes[0])
        if restore and engine.restore_checkpoint():
            print(f"[serve] restored tick {engine._tick} from "
                  f"{args.checkpoint_dir} ({len(engine.completed)} requests "
                  "already complete)", flush=True)
        else:
            for p in prompts:
                engine.submit(p, max_new_tokens=args.max_new)
        t0 = time.perf_counter()
        try:
            if engine.busy:
                engine.step()
                print(f"[serve] tick {engine._tick} done: "
                      f"{len(engine.scheduler.queued)} queued, "
                      f"{int(np.sum(engine.session.live_rows()))} live",
                      flush=True)
            engine.run_to_completion()
        except Preempted as p:
            engine.close()
            if args.inject == "sigterm":
                # injected preemption: recover in this process, as a
                # restarted --restore process would
                print(f"[serve] {p}; recovering in-process", flush=True)
                return run_engine(restore=True)
            print(f"[serve] {p}", flush=True)
            sys.exit(PREEMPTED_EXIT_CODE)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        engine.close()
        return engine, time.perf_counter() - t0

    schedule = None
    if args.inject == "pool_exhausted":
        schedule = FaultSchedule.at(pool_exhausted=range(8))
    elif args.inject == "sigterm":
        schedule = FaultSchedule.once("sigterm", visit=2)
    elif args.inject is not None:
        schedule = FaultSchedule.once(args.inject, visit=1)
    inj = faultinject.install(schedule) if schedule else None
    try:
        engine, dt = run_engine(args.restore)
    finally:
        faultinject.uninstall()
    done = engine.completed
    toks = sum(len(r.output) for r in done)
    mgr = engine.session.cache_mgr
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, arch={run.model.name}, "
          f"device={device.type}, mode={args.mode}, cache={mgr.kind}, "
          f"chunk={engine.scheduler.chunk_tokens}, "
          f"megatick={args.megatick}, async={engine.async_ticks}, "
          f"fused_gate={not args.no_fused_gate}, "
          f"quant={args.quant or 'fp'}, temperature={args.temperature})",
          flush=True)
    if inj is not None:
        assert args.inject in inj.fired_sites(), \
            f"--inject {args.inject} never fired (schedule {schedule.plan})"
        recovery = [(e.site, e.action) for e in engine.fault_log]
        print(f"[serve] injected {args.inject} at visits "
              f"{sorted(schedule.plan[args.inject])}; recovery log: "
              f"{recovery}", flush=True)
        if args.inject == "device_lost":
            # the loss degrades IN PLACE: a remesh in the log and a degree
            # below the built mesh's
            assert any(e.action == "remesh" for e in engine.fault_log), \
                "--inject device_lost: no remesh in the fault log"
            assert engine.tp_degree < args.model_par, \
                f"--inject device_lost: tp still {engine.tp_degree}"
            print(f"[serve] remeshed tp {args.model_par}->"
                  f"{engine.tp_degree} (degraded mode, verified replay)",
                  flush=True)
    if args.fault_log:
        n = engine.fault_log.dump_jsonl(args.fault_log, source="engine")
        print(f"[serve] fault log: {n} events -> {args.fault_log}",
              flush=True)
    if args.ci:
        assert len(done) == args.requests, \
            f"CI smoke: {len(done)}/{args.requests} requests completed"
        assert all(r.done and len(r.output) == args.max_new for r in done), \
            "CI smoke: a request missed its token budget"
        if mgr.kind == "paged":
            assert mgr.free_pages == mgr.num_pages, \
                f"CI smoke: page leak ({mgr.free_pages}/{mgr.num_pages} free)"
        got = {r.uid: r.output for r in done}
        assert got == reference(), \
            "CI smoke: tokens diverge from the plain per-tick reference"
        print("[serve] CI smoke OK (every request done, every page freed, "
              "tokens equal to the plain per-tick reference)", flush=True)
    E = model.num_exit_points
    for r in sorted(done, key=lambda r: r.uid):
        line = (f"  req {r.uid}: {len(r.output)} tokens "
                f"exits={sum(1 for e in r.exit_points if e < E)}")
        if r.evictions:
            line += f" evictions={r.evictions}"
        if args.mode == "tree":
            line += f" accepted={sum(r.accept_lens)}"
        print(line, flush=True)


def _serve_pool(args, prompts, meshes, make_engine, model, cache,
                reference) -> None:
    """``--replicas M``: M engines (each over its own mesh, or unsharded)
    behind one ``ReplicaPool``; ``--ci`` holds every request to the
    single-engine reference."""
    from repro_torch.serving import ReplicaPool
    pool = ReplicaPool([make_engine(model, args.megatick,
                                    False if args.sync_ticks else None,
                                    not args.no_fused_gate, cache, mesh=ms)
                        for ms in meshes])
    prs = [pool.submit(p, max_new_tokens=args.max_new) for p in prompts]
    t0 = time.perf_counter()
    pool.run_to_completion()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in pool.completed)
    print(f"[serve] {len(pool.completed)} requests, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s, replicas={args.replicas}, "
          f"mesh=(1,{args.model_par}), mode={args.mode}, "
          f"megatick={args.megatick})", flush=True)
    if args.ci:
        assert len(pool.completed) == args.requests, \
            f"CI smoke: {len(pool.completed)}/{args.requests} completed"
        assert all(r.done and len(r.output) == args.max_new for r in prs), \
            "CI smoke: a pooled request missed its token budget"
        want = reference()
        assert [list(pr.output) for pr in prs] == [
            want[uid] for uid in sorted(want)], \
            "CI smoke: pool tokens diverge from the single-engine reference"
        print("[serve] CI smoke OK (replica-pool token parity with the "
              "single-engine reference)", flush=True)
    if args.fault_log:
        n = pool.fault_log.dump_jsonl(args.fault_log, source="pool")
        for i, rep in enumerate(pool.replicas):
            n += rep.fault_log.dump_jsonl(args.fault_log,
                                          source=f"replica{i}", append=True)
        print(f"[serve] fault log: {n} events -> {args.fault_log}",
              flush=True)
    pool.close()


if __name__ == "__main__":
    main()
