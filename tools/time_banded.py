"""Times the banded scorer and tracer on the device: the Triton kernels
against the plain-XLA recurrence, at one chunk's job counts (unit_batch
2048: the SE scorer sees 8192 jobs, the PE scorer 16384, the SE tracer
1024), on mutated tRex1 jobs.  Both versions must agree exactly.

For each (op, impl) it prints the wall time per call (median of --reps
calls, each ended by block_until_ready) and the device time per call
(summed GPU kernel time in a jax.profiler trace of --reps calls, over
--reps; tools/trace_ops.device_times), next to the card's name and
power limit.

With --e2e it instead maps a generated genome (chip_smoke.py phase 3's
setup, --genome-size) end to end with the device engine built once on
each implementation, timed in the order triton, xla, xla, triton, and
then traces one whole SE and one whole PE run of the kernel build, after
the warm-up that compiles it, for the device's busy share and top ops in
steady state (Python tracing off).  --trace-only skips the plain-XLA
build and the timed runs.

Usage: python tools/time_banded.py [--reps 20]
       python tools/time_banded.py --e2e [--trace-only] [--genome-size N]
           [--se-reads N] [--pe-pairs N]
"""

import argparse
import functools
import os
import shutil
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--trace-only", action="store_true")
    ap.add_argument("--genome-size", type=int, default=1_000_000_000)
    ap.add_argument("--se-reads", type=int, default=200_000)
    ap.add_argument("--pe-pairs", type=int, default=50_000)
    args = ap.parse_args()
    if args.e2e:
        return e2e(args)

    import numpy as np

    import jax

    import __graft_entry__ as g
    from abismal_tpu.kernels.banded_align import (
        build_banded_scorer, build_banded_tracer, prepare_jobs,
    )
    from abismal_tpu.map.pipeline import interpret_kernels
    from abismal_tpu.map.seeds import SeedIndexView
    from chip_smoke import card_line, mutated_jobs
    from trace_ops import device_times

    interp = interpret_kernels()
    card = card_line()
    print(f"devices {jax.devices()}; card: {card}", flush=True)
    nib = SeedIndexView(g._tiny_index()).nib
    base = prepare_jobs(nib, mutated_jobs(nib, 4096, seed=21), 128)[:4]
    out_dir = os.path.join(REPO, ".smoke", "time_banded")
    for op, n_jobs, build in (("scorer", 8192, build_banded_scorer),
                              ("scorer", 16384, build_banded_scorer),
                              ("tracer", 1024, build_banded_tracer)):
        reps = -(-n_jobs // base[0].shape[0])
        inputs = [jax.device_put(np.concatenate([a] * reps)[:n_jobs])
                  for a in base]
        outs = {}
        for impl in ("triton", "xla"):
            f = build(128, interpret=interp, impl=impl)
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(*inputs))
            first = time.perf_counter() - t0
            outs[impl] = [np.asarray(o) for o in jax.tree.leaves(out)]
            walls = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f(*inputs))
                walls.append(time.perf_counter() - t0)
            td = os.path.join(out_dir, f"{op}_{n_jobs}_{impl}")
            with jax.profiler.trace(td):
                for _ in range(args.reps):
                    out = f(*inputs)
                jax.block_until_ready(out)
            t = device_times(td)
            shutil.rmtree(td, ignore_errors=True)
            dev_ms = sum(t["ops"].values()) / 1e6 / args.reps
            top = sorted(t["ops"].items(), key=lambda kv: -kv[1])[:3]
            print(f"{op} J={n_jobs} {impl}: first call {first:.2f}s, wall "
                  f"{statistics.median(walls) * 1e3:.3f} ms/call (median of "
                  f"{args.reps}), device {dev_ms:.3f} ms/call, top ops "
                  f"{[(k[:40], round(v / 1e6 / args.reps, 3)) for k, v in top]}"
                  f"  [{card}]", flush=True)
        same = all(np.array_equal(a, b)
                   for a, b in zip(outs["triton"], outs["xla"]))
        print(f"{op} J={n_jobs}: triton == xla: {same}", flush=True)
        assert same


def trace_run(label, fn, td, card):
    """Runs fn under jax.profiler with Python tracing off and prints the
    wall time, the device's busy time and idle share over the window from
    the first kernel to the last, and the top device ops."""
    import jax

    from trace_ops import device_times

    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    t0 = time.perf_counter()
    with jax.profiler.trace(td, profiler_options=opts):
        fn()
    wall = time.perf_counter() - t0
    t = device_times(td)
    shutil.rmtree(td, ignore_errors=True)
    total = sum(t["ops"].values())
    win = max(t["window_ns"], 1.0)
    print(f"{label}: wall {wall:.3f}s under the profiler; device busy "
          f"{t['busy_ns'] / 1e6:.1f} ms of a {win / 1e6:.1f} ms window "
          f"(idle share {1 - t['busy_ns'] / win:.4f})  [{card}]", flush=True)
    for name, dur in sorted(t["ops"].items(), key=lambda kv: -kv[1])[:25]:
        print(f"   {dur / 1e6:9.3f} ms  {100 * dur / max(total, 1):5.1f}%  "
              f"{name[:80]}", flush=True)


def e2e(args):
    import time as _t

    import chip_smoke as cs
    from abismal_tpu.kernels import banded_align
    from abismal_tpu.map import pipeline

    card = cs.card_line()
    thr = os.cpu_count() or 1
    ctx = {"threads": thr, "card": card}
    os.makedirs(cs.WORK, exist_ok=True)
    index, _fa, se_fq, pe1, pe2 = cs.scale_setup(ctx, args)
    dev = pipeline.DeviceIndex(index)
    runs = {"SE": (se_fq, None, args.se_reads),
            "PE": (pe1, pe2, args.pe_pairs)}
    warm = {k: (cs.head_fastq(f1, os.path.join(cs.WORK, f"w{k}1.fq"), 4096),
                f2 and cs.head_fastq(f2, os.path.join(cs.WORK, f"w{k}2.fq"),
                                     4096))
            for k, (f1, f2, _n) in runs.items()}
    facs = {}
    builders = (banded_align.build_banded_scorer,
                banded_align.build_banded_tracer)
    for impl in ("triton",) if args.trace_only else ("triton", "xla"):
        # the engine's programs take the builders from the kernels module
        # when they are built: bind the implementation there, and drop the
        # memoized programs of the other one
        banded_align.build_banded_scorer, banded_align.build_banded_tracer \
            = (functools.partial(b, impl=impl) for b in builders)
        pipeline._stage12_memo.clear()
        pipeline._stage12pe_memo.clear()
        eng = pipeline.TpuNativeEngine(index, lmax=128, n_threads=thr,
                                       device_index=dev)

        def fac(*_a, eng=eng):
            return eng

        fac.is_native = True
        facs[impl] = fac
        for kind, (w1, w2) in warm.items():
            t0 = _t.perf_counter()
            cs.map_timed(index, w1, w2, os.path.join(cs.WORK, "w.sam"), fac,
                         thr)
            print(f"{impl} {kind} first call (compile + 4096): "
                  f"{_t.perf_counter() - t0:.1f}s", flush=True)
    banded_align.build_banded_scorer, banded_align.build_banded_tracer = \
        builders
    for kind, (f1, f2, n) in runs.items():
        if args.trace_only:
            break
        unit = "reads/s" if kind == "SE" else "pairs/s"
        md5s = set()
        for impl in ("triton", "xla", "xla", "triton"):
            sam = os.path.join(cs.WORK, "e2e.sam")
            dt = cs.map_timed(index, f1, f2, sam, facs[impl], thr)
            md5s.add(cs.md5_file(sam))
            print(f"{kind} {impl}: {n / dt:.1f} {unit} ({n} in {dt:.2f}s, "
                  f"{thr} host threads)  [{card}]", flush=True)
        print(f"{kind}: outputs identical across runs: {len(md5s) == 1}",
              flush=True)
        assert len(md5s) == 1
    for kind, (f1, f2, n) in runs.items():
        trace_run(f"{kind} triton, all {n} "
                  f"{'reads' if kind == 'SE' else 'pairs'}",
                  lambda: cs.map_timed(index, f1, f2,
                                       os.path.join(cs.WORK, "t.sam"),
                                       facs["triton"], thr),
                  os.path.join(cs.WORK, f"trace_{kind}"), card)
    shutil.rmtree(cs.WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
