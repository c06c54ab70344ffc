"""Benchmark: end-to-end mapping throughput, md5-verified.

Maps simulated 100bp SE WGBS reads (1% mutations, bisulfite converted)
against the tRex1 index and verifies the SAM output is md5-identical to
the upstream golden before reporting.  Engine configurations are timed,
each in its own subprocess (one at a time, so only one process ever uses
the card):

  native    -- fully-native streaming engine: C++ FASTQ parse + seeding +
               decide/align/format + ordered SAM write;
  hybrid    -- the device engine (fused device stage-1+2 + native
               finalize);
  split     -- native + device engines on disjoint read shards;
  pe_native / pe_hybrid -- paired-end, pairs/s.

Each configuration repeats the mapping and reports the best and median
md5-verified repetition.  A device mode that fails, times out or never
produces verified output fails the whole run (exit 1, no JSON).  Prints
ONE JSON line naming the device (JAX platform, device kind and count,
the card's name and power limit from nvidia-smi).
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GOLDEN_SAM_MD5 = "8126d46074213ad3674181f4ea4f8bd1"
N_READS = 10000
N_REPS = {"native": 20, "hybrid": 10, "split": 10, "pe_native": 8,
          "pe_hybrid": 6}
DEVICE_DEADLINE_S = int(os.environ.get("ABISMAL_BENCH_DEADLINE", "1800"))
DEVICE_MODES = ("hybrid", "split", "pe_hybrid")


def _device() -> dict:
    """The device this process maps on, as JAX and nvidia-smi report it."""
    import jax

    from chip_smoke import card_line

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card_line()}


def _bench_mode(mode: str) -> dict:
    """Times one engine configuration; returns {"best", "median",
    "fallback"} where best/median are md5-verified reads/s over the reps
    and fallback is the device stage-1 fallback-unit fraction (hybrid)."""
    import statistics

    import __graft_entry__ as g
    from abismal_tpu.map.engine import run_map
    from abismal_tpu.map.pipeline import (
        make_native_engine_factory,
        make_tpu_native_engine_factory,
    )
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    index = g._tiny_index()
    genome = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data", "tRex1.fa")
    d = tempfile.mkdtemp(prefix="abismal_bench_")
    simulate_reads(genome, SimConfig(
        output_prefix=os.path.join(d, "r"), n_reads=N_READS,
        mutation_rate=0.01, bs_conv=0.98, seed=1, single_end=True))
    fq = os.path.join(d, "r_1.fq")
    sam = os.path.join(d, "out.sam")

    threads = os.cpu_count() or 1
    cl = ("map -s tests/reads.mstats -o tests/reads.sam -i tests/tRex1.idx "
          "tests/reads_1.fq")

    if mode == "split":
        # native + device engines on disjoint read shards, concurrently;
        # the split point is calibrated from single-engine rates measured
        # on this box right now.  A 10x larger read set is used so the
        # device shard spans several pipelined chunks (at 10k reads it is
        # a single padded chunk); ground truth for the big set is the
        # native engine's own output, which is itself md5-verified against
        # the upstream golden on the 10k set above.
        from abismal_tpu.io.sam import make_sam_header
        from abismal_tpu.map.hybrid_split import (
            NativeShardServer,
            run_map_hybrid_split,
        )

        n_big = 10 * N_READS
        simulate_reads(genome, SimConfig(
            output_prefix=os.path.join(d, "big"), n_reads=n_big,
            mutation_rate=0.01, bs_conv=0.98, seed=2, single_end=True))
        big_fq = os.path.join(d, "big_1.fq")

        # the host shard runs in its own pristine worker process (the
        # native engine measures ~40% slower inside the JAX process)
        idx_path = os.path.join(tempfile.gettempdir(),
                                "abismal_tpu_test_cache", "tRex1.idx")
        srv = NativeShardServer(idx_path, threads=threads)
        dev_f = make_tpu_native_engine_factory(n_threads=1)
        dev = dev_f(index, False, 0.1, 32, 3000)
        hdr = make_sam_header(index.cl, cl).encode()

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        def nat_only(src, n, dst):
            srv.map_range(src, None, dst, hdr, False, False, 0, n, False,
                          False)
            srv.wait()

        def split_once(share):
            return timed(lambda: run_map_hybrid_split(
                index, big_fq, None, sam, cl, device_share=share,
                threads=threads, native_server=srv, tpu_engine=dev,
                total_reads=n_big))

        # 10k-set md5 verification of the worker's output anchors the
        # big-set ground truth
        nat_only(fq, N_READS, sam)
        if hashlib.md5(open(sam, "rb").read()).hexdigest() != GOLDEN_SAM_MD5:
            raise RuntimeError("native shard output differs from golden")
        t_nat = min(timed(lambda: nat_only(big_fq, n_big, sam))
                    for _ in range(2))
        truth_md5 = hashlib.md5(open(sam, "rb").read()).hexdigest()
        split_once(0.1)  # warmup: device compile + first transfers
        t_dev = timed(lambda: run_map(
            index, big_fq, None, sam, None, cl, engine_factory=dev_f,
            threads=threads))
        share = (1.0 / t_dev) / (1.0 / t_dev + 1.0 / t_nat)
        rates = []
        for _ in range(N_REPS[mode]):
            dt = split_once(share)
            got = hashlib.md5(open(sam, "rb").read()).hexdigest()
            if got == truth_md5:
                rates.append(n_big / dt)
        srv.close()
        n_units = getattr(dev, "n_units", 0)
        fallback = ((getattr(dev, "n_fallback", 0) / n_units)
                    if n_units else None)
        return {
            "best": _best(rates),
            "median": statistics.median(rates),
            "fallback": fallback,
            "device_share": round(share, 4),
        }

    if mode in ("pe_native", "pe_hybrid"):
        # paired-end throughput (VERDICT r4 ask #8): simulate pairs, map
        # with the engine under test, and verify against the native
        # engine's own output (which is byte-identical to the upstream
        # binary -- tests/test_map.py pins the PE goldens)
        n_pairs = N_READS // 2
        simulate_reads(genome, SimConfig(
            output_prefix=os.path.join(d, "p"), n_reads=n_pairs,
            mutation_rate=0.01, bs_conv=0.98, seed=3, single_end=False))
        fq1, fq2 = os.path.join(d, "p_1.fq"), os.path.join(d, "p_2.fq")
        nat = make_native_engine_factory(n_threads=threads)
        run_map(index, fq1, fq2, sam, None, cl, engine_factory=nat,
                threads=threads)
        truth = hashlib.md5(open(sam, "rb").read()).hexdigest()
        factory = (make_tpu_native_engine_factory(n_threads=threads)
                   if mode == "pe_hybrid" else nat)
        run_map(index, fq1, fq2, sam, None, cl, engine_factory=factory,
                threads=threads)  # warmup
        rates = []
        for _ in range(N_REPS.get(mode, 5)):
            t0 = time.perf_counter()
            run_map(index, fq1, fq2, sam, None, cl,
                    engine_factory=factory, threads=threads)
            dt = time.perf_counter() - t0
            if hashlib.md5(open(sam, "rb").read()).hexdigest() == truth:
                rates.append(n_pairs / dt)
        import statistics as _st

        eng = factory(index, False, 0.1, 32, 3000)
        n_units = getattr(eng, "n_units", 0)
        fallback = ((getattr(eng, "n_fallback", 0) / n_units)
                    if n_units else None)
        return {
            "best": _best(rates),
            "median": _st.median(rates),
            "fallback": fallback,
        }

    if mode == "hybrid":
        factory = make_tpu_native_engine_factory(n_threads=threads)
    else:
        factory = make_native_engine_factory(n_threads=threads)

    # warmup: engine construction, device compile, first-transfer path
    run_map(index, fq, None, sam, None, cl, engine_factory=factory,
            threads=threads)

    rates = []
    for _ in range(N_REPS[mode]):
        t0 = time.perf_counter()
        run_map(index, fq, None, sam, None, cl, engine_factory=factory,
                threads=threads)
        dt = time.perf_counter() - t0
        got = hashlib.md5(open(sam, "rb").read()).hexdigest()
        if got == GOLDEN_SAM_MD5:
            rates.append(N_READS / dt)
    # the memoizing factory returns the live engine: read its device
    # fallback counters so a regressing device path is visible in BENCH
    eng = factory(index, False, 0.1, 32, 3000)
    n_units = getattr(eng, "n_units", 0)
    fallback = (getattr(eng, "n_fallback", 0) / n_units) if n_units else None
    return {
        "best": _best(rates),
        "median": statistics.median(rates),
        "fallback": fallback,
    }


def _best(rates):
    if not rates:
        raise RuntimeError("no md5-verified repetition")
    return max(rates)


def _run_child(mode: str, deadline: float | None):
    """Runs one mode in a fresh process; returns its result dict, or None
    when it failed, timed out or printed no result."""
    try:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mode", mode],
            capture_output=True, text=True, timeout=deadline)
    except (subprocess.TimeoutExpired, OSError) as e:
        print(f"bench mode {mode} did not finish: {e}", file=sys.stderr)
        return None
    for line in p.stdout.splitlines():
        if line.startswith("{") and p.returncode == 0:
            return json.loads(line)
    print(f"bench mode {mode} failed (exit {p.returncode}):\n"
          f"{p.stderr[-4000:]}", file=sys.stderr)
    return None


def _merge(a: dict, b: dict) -> dict:
    return b if (a is None or b["best"] > a["best"]) else a


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--mode":
        # child invocation: print one JSON dict and exit
        r = _bench_mode(sys.argv[2])
        r["device"] = _device()
        print(json.dumps(r))
        return 0

    threads = os.cpu_count() or 1
    results = {}
    # native first, alone; two independent children, best taken:
    # per-process cache/page state swings single-process results by ~30%
    for _ in range(2):
        r = _run_child("native", None)
        if r is None:
            return 1
        results["native"] = _merge(results.get("native"), r)
    pe = {}
    for mode in ("hybrid", "split", "pe_native", "pe_hybrid"):
        r = _run_child(mode,
                       DEVICE_DEADLINE_S if mode in DEVICE_MODES else None)
        if r is None:
            return 1
        (pe if mode.startswith("pe_") else results)[mode] = r

    mode = max(results, key=lambda m: results[m]["best"])
    reads_per_s = results[mode]["best"]
    desc = {"hybrid": "device stage-1+2 + native finalize",
            "split": "hybrid split: native engine + device engine on "
                     "disjoint read shards, concurrently",
            "native": "fully-native streaming engine"}[mode]
    # all modes' best/median rates and the device fallback fraction ride
    # along so artifacts record variance and device-path health, not just
    # the winning peak
    detail = {m: {"best": round(v["best"], 1),
                  "median": round(v["median"], 1),
                  **({"fallback_frac": round(v["fallback"], 5)}
                     if v.get("fallback") is not None else {}),
                  **({"device_share": v["device_share"]}
                     if v.get("device_share") is not None else {})}
              for m, v in {**results, **pe}.items()}
    for m in pe:
        detail[m]["unit"] = "pairs/s"
    print(json.dumps({
        "metric": "end-to-end SE mapping, "
                  f"{desc} ({threads} threads), output md5-verified",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "device": results["hybrid"]["device"],
        "modes": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
