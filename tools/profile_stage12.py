"""Bisection profiler for the fused device stage-1+2 SE program.

Builds the stage12 program cut at successive points (core -> decide ->
jobs -> score -> full) and times each variant on the device with a
realistic tRex1 workload.  Timing protocol: queue N executions
back-to-back (device executions serialize on one device) and force
completion with a single host fetch.  The per-cut deltas localize the
cost.

Usage: python tools/profile_stage12.py [unit_batch] [reps] [cuts...]
       ABISMAL_PROFILE_INDEX=/path/to.idx ABISMAL_PROFILE_GENOME=/path.fa \
           python tools/profile_stage12.py ...   # GB-scale variant
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np

    import __graft_entry__ as g
    from abismal_tpu.map.pipeline import (
        TpuNativeEngine,
        interpret_kernels,
        build_stage12,
        prepare_units,
    )

    unit_batch = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    import jax

    print(f"backend={jax.default_backend()} devices={jax.devices()}",
          flush=True)

    idx_path = os.environ.get("ABISMAL_PROFILE_INDEX")
    if idx_path:
        from abismal_tpu.index.serialize import read_index

        index = read_index(idx_path)
        genome = os.environ["ABISMAL_PROFILE_GENOME"]
    else:
        index = g._tiny_index()
        genome = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "data", "tRex1.fa")
    eng = TpuNativeEngine(
        index, lmax=int(os.environ.get("ABISMAL_PROFILE_LMAX", 128)),
        unit_batch=unit_batch, n_threads=1)

    # realistic reads simulated from the profiled genome
    import tempfile

    from abismal_tpu.io.fastq import ReadLoader
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    d = tempfile.mkdtemp(prefix="abismal_prof_")
    simulate_reads(genome, SimConfig(
        output_prefix=os.path.join(d, "r"), n_reads=unit_batch // 2,
        mutation_rate=0.01, bs_conv=0.98, seed=1, single_end=True))
    reads = ReadLoader(os.path.join(d, "r_1.fq"),
                       batch_size=unit_batch // 2).load_batch()
    print(f"reads={len(reads)} unit_batch={unit_batch}", flush=True)

    units, per, _ = eng._se_units_dense(reads, False, False)
    scode = eng._se_scode_pattern(False, False)
    from abismal_tpu.map.pipeline import get_conv_is_ga
    is_ga_pat = np.array([get_conv_is_ga(int(c)) for c in scode], dtype=bool)
    preads, lens = prepare_units(units, eng.lmax)
    B = unit_batch - (unit_batch % per)
    pad = B - len(units)
    if pad:
        preads = np.pad(preads, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    rpc = B // per
    lens_r = lens.reshape(rpc, per).max(axis=1)
    max_diffs_r = (0.1 * lens_r.astype(np.float64)).astype(np.int32)
    is_ga = np.tile(is_ga_pat, rpc)

    tables = eng.dev.tables()
    args_np = (preads, lens, is_ga, scode, max_diffs_r)
    args = tuple(jax.device_put(a) for a in args_np)

    prev = 0.0
    cuts = ("hash", "ranges", "extend", "list", "core", "compact",
            "decide", "jobs", "score", None)
    if len(sys.argv) > 3:
        cuts = tuple(c if c != "full" else None for c in sys.argv[3:])
    for cut in cuts:
        prog, _ = build_stage12(eng.lmax, eng.dev.max_candidates,
                                eng.dev.n_index2, eng.dev.n_index3, per,
                                interpret=interpret_kernels(),
                                cut=cut, ext_iters=eng.dev.ext_iters)
        t0 = time.perf_counter()
        out = prog(*tables, *args)
        np.asarray(out)  # force compile + first exec
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = prog(*tables, *args)
        np.asarray(out)
        dt = (time.perf_counter() - t0) / reps
        name = cut or "full"
        print(f"{name:8s} exec={dt*1e3:8.2f} ms/chunk  "
              f"delta={(dt-prev)*1e3:8.2f} ms  "
              f"({dt*1e6/unit_batch:7.2f} us/unit)  compile={compile_s:.1f}s",
              flush=True)
        prev = dt


if __name__ == "__main__":
    main()
