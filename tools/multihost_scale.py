"""Multi-host weak-scaling measurement (BASELINE: >=85% efficiency at 2+
hosts): fixed per-host work, host count doubled, efficiency =
throughput(N) / (N * throughput(1)).

Each simulated host is a separate spawned process with its own index
replica and 2 worker threads, mapping its read-range shard of the shared
FASTQ; the gather concatenates shard SAMs in rank order.

Usage: python tools/multihost_scale.py [--per-host 20000] [--hosts 1 2]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-host", type=int, default=20000)
    ap.add_argument("--hosts", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()

    import __graft_entry__ as g
    from abismal_tpu.parallel.multihost import run_map_multihost
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    g._tiny_index()  # ensure the cached serialized index exists
    idx_path = os.path.join(tempfile.gettempdir(), "abismal_tpu_test_cache",
                            "tRex1.idx")
    genome = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "tRex1.fa")
    d = tempfile.mkdtemp(prefix="abismal_mh_")

    results = {}
    for n in a.hosts:
        total = a.per_host * n
        pre = os.path.join(d, f"r{n}")
        simulate_reads(genome, SimConfig(
            output_prefix=pre, n_reads=total, mutation_rate=0.01,
            bs_conv=0.98, seed=1, single_end=True))
        out = os.path.join(d, f"out{n}.sam")
        best = None
        for _ in range(a.reps):
            t0 = time.perf_counter()
            run_map_multihost(idx_path, pre + "_1.fq", None, out,
                              "weak-scaling bench", n_hosts=n,
                              threads_per_host=a.threads)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        results[n] = total / best
        print(f"hosts={n} ({a.threads} threads each): {total} reads in "
              f"{best:.2f}s = {results[n]:.0f} reads/s", flush=True)

    base = min(results)
    for n in sorted(results):
        eff = results[n] / (results[base] * n / base)
        print(f"weak-scaling efficiency at {n} host(s): {100 * eff:.0f}%")


if __name__ == "__main__":
    main()
