"""Bisection profiler for the fused device stage-1+2 PE program (mirror
of tools/profile_stage12.py): builds the stage12pe program cut at
successive points and times each variant on the device with a
realistic paired workload.  The per-cut deltas localize the cost.

Usage: python tools/profile_stage12pe.py [unit_batch] [reps] [cuts...]
       ABISMAL_PROFILE_INDEX=/path/to.idx ABISMAL_PROFILE_GENOME=/path.fa \
           python tools/profile_stage12pe.py ...   # GB-scale variant
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
        build_stage12pe,
        get_conv_is_ga,
    )

    unit_batch = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10

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
    lmax = int(os.environ.get("ABISMAL_PROFILE_LMAX", 128))
    eng = TpuNativeEngine(index, lmax=lmax, unit_batch=unit_batch,
                          n_threads=1)

    import tempfile

    from abismal_tpu.io.fastq import ReadLoader
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    d = tempfile.mkdtemp(prefix="abismal_ppe_")
    n_pairs = unit_batch // 4
    simulate_reads(genome, SimConfig(
        output_prefix=os.path.join(d, "r"), n_reads=n_pairs,
        mutation_rate=0.01, bs_conv=0.98, seed=1, single_end=False))
    r1 = ReadLoader(os.path.join(d, "r_1.fq"),
                    batch_size=n_pairs).load_batch()
    r2 = ReadLoader(os.path.join(d, "r_2.fq"),
                    batch_size=n_pairs).load_batch()
    print(f"pairs={len(r1)} unit_batch={unit_batch}", flush=True)

    pnib, lens, per, _ = eng._pe_units_mat(r1, r2, False, False)
    is_ga_pat = eng._pe_is_ga_pattern(False, False)
    B = unit_batch - (unit_batch % per)
    pad = B - pnib.shape[0]
    if pad > 0:
        pnib = np.pad(pnib, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    max_diffs_u = (0.1 * lens.astype(np.float64)).astype(np.int32)
    is_ga = np.tile(is_ga_pat, B // per)
    pe_dist = np.array([32, 3000], dtype=np.int32)

    tables = eng.dev.tables()
    args = tuple(jax.device_put(a) for a in
                 (pnib, lens, is_ga, max_diffs_u, pe_dist))
    eng._budget_for((pnib, lens), is_ga_pat, per)
    ext_pool = eng._informed_ext_pool()
    budget = eng.cand_budget
    print(f"budget={budget} ext_pool={ext_pool} per={per}", flush=True)

    prev = 0.0
    cuts = ("hash", "ranges", "extend", "list", "pecompact", "pejobs",
            "pescore", None)
    if len(sys.argv) > 3:
        cuts = tuple(c if c != "full" else None for c in sys.argv[3:])
    for cut in cuts:
        prog, _ = build_stage12pe(
            eng.lmax, eng.dev.max_candidates, eng.dev.n_index2,
            eng.dev.n_index3, per=per, cand_per_unit=budget,
            interpret=interpret_kernels(), cut=cut,
            ext_iters=eng.dev.ext_iters, ext_pool=ext_pool)
        t0 = time.perf_counter()
        out = prog(*tables, *args)
        np.asarray(out)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = prog(*tables, *args)
        np.asarray(out)
        dt = (time.perf_counter() - t0) / reps
        name = cut or "full"
        print(f"{name:10s} exec={dt*1e3:8.2f} ms/chunk  "
              f"delta={(dt-prev)*1e3:8.2f} ms  "
              f"({dt*1e6/unit_batch:7.2f} us/unit)  compile={compile_s:.1f}s",
              flush=True)
        prev = dt


if __name__ == "__main__":
    main()
