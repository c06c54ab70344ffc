"""End-to-end mapping profile: per-stage wall/CPU breakdown + optional JAX
profiler trace (SURVEY 5 north-star: kernel speed-of-light analysis).

Runs a simulated 100bp SE workload through the selected engine and prints a
stage table.  For the native engine the table is the in-library nanosecond
accounting (seed / align / format / parse, summed across worker threads);
for the device engine it is the Python-side stage accumulators (unit
prep / device dispatch / device collect / native stage-2).  --trace wraps
the run in jax.profiler.trace; tools/trace_ops.py device_times reduces it
to device busy time and per-op kernel time.

Usage:
  python tools/profile.py [--engine native|tpu] [--reads 10000]
      [--threads N] [--reps 3] [--trace /tmp/abismal_trace]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="native", choices=["native", "tpu"])
    ap.add_argument("--reads", type=int, default=10000)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default="")
    a = ap.parse_args()

    import numpy as np

    import __graft_entry__ as g
    from abismal_tpu.map.engine import run_map
    from abismal_tpu.map.pipeline import (
        make_native_engine_factory,
        make_tpu_native_engine_factory,
    )
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    index = g._tiny_index()
    genome = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "tRex1.fa")
    d = tempfile.mkdtemp(prefix="abismal_prof_")
    simulate_reads(genome, SimConfig(
        output_prefix=os.path.join(d, "r"), n_reads=a.reads,
        mutation_rate=0.01, bs_conv=0.98, seed=1, single_end=True))
    fq = os.path.join(d, "r_1.fq")
    sam = os.path.join(d, "out.sam")

    if a.engine == "tpu":
        base = make_tpu_native_engine_factory(n_threads=a.threads)
    else:
        base = make_native_engine_factory(n_threads=a.threads)
    # pin ONE engine across reps so its stage accounting accumulates
    eng = base(index, False, 0.1, 32, 3000)

    def factory(*_args):
        return eng

    factory.is_native = True

    def run_once():
        return run_map(index, fq, None, sam, None, "profile run",
                       engine_factory=factory, threads=a.threads)

    run_once()  # warmup: engine construction + device compile
    native = eng if hasattr(eng, "lib") else eng.native
    native.lib.engine_set_profile(native._ctx, 1)
    ns = np.zeros(16, dtype=np.int64)
    native.lib.engine_stage_ns(native._ctx, ns.ctypes.data, 1)  # reset
    if hasattr(eng, "stage_time"):
        for k in eng.stage_time:
            eng.stage_time[k] = 0.0

    def timed_reps():
        t0 = time.perf_counter()
        for _ in range(a.reps):
            run_once()
        return time.perf_counter() - t0

    if a.trace:
        import jax

        with jax.profiler.trace(a.trace):
            wall = timed_reps()
        print(f"[jax trace written to {a.trace}]")
    else:
        wall = timed_reps()

    n = a.reps * a.reads
    print(f"engine={a.engine} threads={a.threads}: {n} reads in "
          f"{wall:.2f}s = {n / wall:.0f} reads/s")
    native.lib.engine_stage_ns(native._ctx, ns.ctypes.data, 0)
    cpu = max(1, int(ns[:4].sum()))
    print("native stage table (CPU seconds summed over worker threads):")
    for name, v in zip(("seed", "align", "format", "parse"), ns[:4]):
        print(f"  {name:8s} {v / 1e9:8.2f}s  ({100 * int(v) // cpu}%)")
    st = getattr(eng, "stage_time", None)
    if st:
        print("hybrid stage table (wall seconds):")
        for k, v in st.items():
            print(f"  {k:16s} {v:8.2f}s  ({100 * v / wall:.0f}%)")
        print(f"  fallback units: {eng.n_fallback}/{eng.n_units}")


if __name__ == "__main__":
    main()
