"""Smoke run of the device mapping engine on one GPU.

Drives the engine through its normal entry points and checks every result
exactly (all device arithmetic is integer, so every comparison is exact
equality):

  phase 0  the device: JAX devices and version, the card's name and power
           limit, the compile-cache path; builds the native libraries.
  phase 1  kernels at real widths: the Triton banded scorer and tracer,
           compiled for the card, on 4096 mutated tRex1 jobs against the
           host aligner (scores) and the native traceback (cigars), and
           against the plain-XLA recurrence; the fused SE and PE programs
           compiled at unit_batch 2048 (compile seconds, memory analysis);
           the `gpu`-marked tests.
  phase 2  goldens through the CLI: `map --engine tpu` on the 10k-read
           SE, PE, PBAT-PE and RPBAT-PE goldens (SAM and mstats md5 equal
           to the golden's; the SAM's @PG CL field, which records argv, is
           set to the golden's command first), and `--engine hybrid`,
           `--engine tpu-replay` and `--device-align` on the SE golden.
  phase 3  a generated 1 Gb genome (tools/scale_test.py gen_genome, seed
           11): native index build, 200k SE reads and 50k PE pairs
           simulated, mapped by the native and the device engine; the
           SAMs must be byte-identical.

Everything runs in this one process (never two JAX processes on a card),
except the `--hosts 4` run of --four, whose four shard processes each
open one card while this process has opened none.

Usage:
  python chip_smoke.py             # every phase on one GPU
  python chip_smoke.py --four      # only the four-GPU paths (--hosts 4,
                                   # --mesh 4, --index-shards 4), each
                                   # vs the native engine
  JAX_PLATFORMS=cpu python chip_smoke.py --genome-size 20000000 \\
      --se-reads 4000 --pe-pairs 1000     # CPU rehearsal; exits non-zero

The last line of stdout is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed on a GPU.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
WORK = os.path.join(REPO, ".smoke")
DEFAULT_GENOME = 1_000_000_000
REHEARSAL_MAX_GENOME = 50_000_000  # largest genome a non-GPU run may use
LMAX = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi: no card found"


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def md5_without_pg(path: str) -> str:
    """md5 of a SAM without its @PG line (whose CL field records argv)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b"@PG"):
                h.update(line)
    return h.hexdigest()


def gunzip(name: str) -> str:
    out = os.path.join(WORK, name)
    if not os.path.exists(out):
        with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as f, \
                open(out, "wb") as g:
            shutil.copyfileobj(f, g)
    return out


# --- phase 1 helpers ---------------------------------------------------------

def mutated_jobs(nib, n: int, seed: int = 5):
    """n alignment jobs (query nibbles, diffs, max_diffs, pos) drawn from
    the genome nibbles with substitutions, an insertion and/or a deletion,
    and a random bisulfite encoding; 2*min(diffs, max_diffs)+1 <= BW_MAX."""
    import numpy as np

    from abismal_tpu.map.seeds import prep_read

    rng = np.random.default_rng(seed)
    to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    G = nib.shape[0]
    jobs = []
    while len(jobs) < n:
        p = int(rng.integers(40000, G - 40000))
        length = int(rng.integers(60, LMAX + 1))
        s = bytearray(to_char[nib[p : p + length]].tobytes()
                      .replace(b"Z", b"A"))
        for _ in range(int(rng.integers(0, 10))):
            s[int(rng.integers(0, length))] = ord(rng.choice(list("ACGT")))
        if rng.random() < 0.5:
            s.insert(int(rng.integers(10, length - 10)),
                     ord(rng.choice(list("ACGT"))))
        if rng.random() < 0.5:
            del s[int(rng.integers(10, len(s) - 10))]
        q = prep_read(bytes(s[:LMAX]), bool(rng.integers(0, 2)))
        jobs.append((q, int(rng.integers(1, 31)), int(rng.integers(1, 31)),
                     p))
    return jobs


def assemble_cigar(ops_row, meta_row, qsz: int):
    """Device traceback row -> (cigar ops, aligned length, position), in
    the native build_cigar_len_and_pos form."""
    from abismal_tpu.constants import CIGAR_SHIFT, CIGAR_SOFT

    n_ops, sb, st, npos = (int(x) for x in meta_row)
    if n_ops < 0:
        return None
    cigar = []
    if st > 0:
        cigar.append((st << CIGAR_SHIFT) | CIGAR_SOFT)
    cigar.extend(int(x) for x in ops_row[:n_ops][::-1])
    if sb > 0:
        cigar.append((sb << CIGAR_SHIFT) | CIGAR_SOFT)
    return cigar, qsz - sb - st, npos & 0xFFFFFFFF


def phase1(ctx, args):
    import numpy as np

    import jax

    from abismal_tpu.index.build import create_index
    from abismal_tpu.index.serialize import write_index
    from abismal_tpu.kernels.banded_align import (
        build_banded_scorer, prepare_jobs,
    )
    from abismal_tpu.map.align import BandedAligner
    from abismal_tpu.map.pipeline import (
        DeviceIndex, build_stage12, build_stage12pe, build_tb_block,
        interpret_kernels,
    )
    from abismal_tpu.map.seeds import SeedIndexView

    interp = interpret_kernels()
    t0 = time.perf_counter()
    index = create_index(os.path.join(REPO, "tests", "data", "tRex1.fa"),
                         n_threads=os.cpu_count() or 1)
    idx_path = os.path.join(WORK, "tRex1.idx")
    write_index(index, idx_path)
    want = open(os.path.join(GOLDEN, "tRex1.idx.md5")).read().strip()
    assert md5_file(idx_path) == want, "tRex1 index md5 differs"
    ctx["trex1_idx"] = idx_path
    log(f"[1] tRex1 index built and md5-equal in "
        f"{time.perf_counter() - t0:.1f}s")

    nib = SeedIndexView(index).nib
    jobs = mutated_jobs(nib, 4096)
    aln = BandedAligner(nib, use_native=True)
    aln.reset(LMAX)
    want_s, want_c = [], []
    for q, d, md, p in jobs:
        want_s.append(aln.align(d, md, q, p, True))
        want_c.append(aln.build_cigar_len_and_pos(d, md, p))
    q_rows, win, bw, qsz, _ = prepare_jobs(nib, jobs, LMAX)
    want_s = np.array(want_s)
    for impl in ("triton", "xla"):
        scorer = build_banded_scorer(LMAX, interpret=interp, impl=impl)
        t0 = time.perf_counter()
        got = np.asarray(scorer(q_rows, win, bw, qsz))[: len(jobs), 0]
        dt = time.perf_counter() - t0
        bad = int((got != want_s).sum())
        log(f"[1] scorer {impl}: {len(jobs)} jobs, lmax {LMAX}, first call "
            f"(compile + run) {dt:.1f}s, mismatches vs host aligner {bad}")
        assert bad == 0, f"{impl} scorer differs from the host aligner"

    tb = build_tb_block(LMAX, interpret=interp)
    pos = np.array([p for *_, p in jobs], dtype=np.uint32)
    t0 = time.perf_counter()
    ops, meta = (np.asarray(a) for a in tb(
        q_rows, win, bw[:, 0], qsz[:, 0], pos, np.ones(len(jobs), bool)))
    dt = time.perf_counter() - t0
    n_cmp = n_over = 0
    for i, (q, d, md, p) in enumerate(jobs):
        if want_s[i] <= 0:
            continue
        got = assemble_cigar(ops[i], meta[i], q.shape[0])
        if got is None:  # op buffer overflow: host traceback, by design
            n_over += 1
            continue
        w = want_c[i]
        assert got == (w[0], w[1], w[2] % (1 << 32)), \
            f"device traceback differs from native on job {i}"
        n_cmp += 1
    assert n_cmp > len(jobs) // 2, "too few tracebacks compared"
    log(f"[1] tracer triton: first call {dt:.1f}s, {n_cmp} cigars equal "
        f"to the native traceback ({n_over} op-buffer overflows left to "
        "the host)")

    # the fused programs at unit_batch 2048, compiled ahead of time
    dev = DeviceIndex(index)
    B = 2048
    W = (LMAX + 32) // 2
    S = jax.ShapeDtypeStruct
    import jax.numpy as jnp

    units = (S((B, W), jnp.uint8), S((B,), jnp.int32), S((B,), jnp.bool_))
    progs = {
        "SE": (build_stage12(LMAX, dev.max_candidates, dev.n_index2,
                             dev.n_index3, 2, interpret=interp,
                             ext_iters=dev.ext_iters)[0],
               units + (S((2,), jnp.int32), S((B // 2,), jnp.int32))),
        "PE": (build_stage12pe(LMAX, dev.max_candidates, dev.n_index2,
                               dev.n_index3, per=4, interpret=interp,
                               ext_iters=dev.ext_iters)[0],
               units + (S((B,), jnp.int32), S((2,), jnp.int32))),
    }
    for name, (prog, shapes) in progs.items():
        t0 = time.perf_counter()
        compiled = prog.lower(*dev.tables(), *shapes).compile()
        dt = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        mem = {f: getattr(ma, f, None) for f in fields} if ma else None
        log(f"[1] fused {name} program, unit_batch {B}: compiled in "
            f"{dt:.1f}s; memory_analysis {mem}")
    del dev

    if ctx["platform"] == "gpu":
        import pytest

        os.environ["ABISMAL_TEST_DEVICE"] = "gpu"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")])
        log(f"[1] gpu-marked tests: pytest exit code {int(rc)}")
        assert int(rc) == 0, "gpu-marked tests failed"
    else:
        log("[1] gpu-marked tests: not run (no GPU)")


# --- phase 2 ---------------------------------------------------------------

GOLDEN_RUNS = (
    ("reads", ("reads_1.fq",)),
    ("reads_pe", ("reads_pe_1.fq", "reads_pe_2.fq")),
    ("reads_pbat_pe", ("reads_pbat_pe_1.fq", "reads_pbat_pe_2.fq")),
    ("reads_rpbat_pe", ("reads_rpbat_pe_1.fq", "reads_rpbat_pe_2.fq")),
)


def golden_argv(name: str, fqs, idx_path: str, out_dir: str):
    """The golden's own map command (its @PG CL field) with the paths
    pointed at this run's files; returns (argv, sam, mstats, pg_line)."""
    with gzip.open(os.path.join(GOLDEN, name + ".sam.gz"), "rt") as f:
        pg = next(line for line in f if line.startswith("@PG"))
    cl = pg.split('CL:"', 1)[1].rsplit('"', 1)[0].split()
    sam = os.path.join(out_dir, name + ".sam")
    mst = os.path.join(out_dir, name + ".mstats")
    paths = {f"tests/{name}.sam": sam, f"tests/{name}.mstats": mst,
             "tests/tRex1.idx": idx_path}
    for fq in fqs:
        paths["tests/" + fq] = gunzip(fq)
    return [paths.get(a, a) for a in cl[1:]], sam, mst, pg


def sam_md5_vs_golden(sam: str, pg: str) -> str:
    """md5 of the SAM with its @PG line replaced by the golden's (the CL
    field records this run's argv)."""
    h = hashlib.md5()
    with open(sam, "rb") as f:
        for line in f:
            h.update(pg.encode() if line.startswith(b"@PG") else line)
    return h.hexdigest()


def device_engine():
    from abismal_tpu.map import pipeline

    engines = [e for _, e in pipeline._engine_memo.values()
               if isinstance(e, pipeline.TpuNativeEngine)]
    return engines[-1] if engines else None


def run_cli(argv):
    from abismal_tpu.cli import main as cli_main
    from abismal_tpu.map import pipeline

    pipeline._engine_memo.clear()
    t0 = time.perf_counter()
    rc = cli_main(["map"] + list(argv))
    assert rc == 0, f"map {' '.join(argv)} returned {rc}"
    return time.perf_counter() - t0


def fallback_of(eng) -> str:
    if eng is None or not eng.n_units:
        return "n/a"
    return f"{eng.n_fallback / eng.n_units:.5f}"


def phase2(ctx, args):
    out_dir = os.path.join(WORK, "golden_out")
    os.makedirs(out_dir, exist_ok=True)
    idx = ctx["trex1_idx"]
    for name, fqs in GOLDEN_RUNS:
        argv, sam, mst, pg = golden_argv(name, fqs, idx, out_dir)
        dt = run_cli(["--engine", "tpu", "-t", str(ctx["threads"])] + argv)
        eng = device_engine()
        got_sam = sam_md5_vs_golden(sam, pg)
        want_sam = hashlib.md5(gzip.open(os.path.join(
            GOLDEN, name + ".sam.gz")).read()).hexdigest()
        want_mst = hashlib.md5(gzip.open(os.path.join(
            GOLDEN, name + ".mstats.gz")).read()).hexdigest()
        got_mst = md5_file(mst)
        decided = eng.n_units - eng.n_fallback if eng else 0
        log(f"[2] --engine tpu {name}: {dt:.1f}s, SAM md5 {got_sam} "
            f"(golden {want_sam}), mstats md5 {got_mst} (golden "
            f"{want_mst}), device fallback {fallback_of(eng)}")
        assert got_sam == want_sam and got_mst == want_mst, \
            f"{name}: output differs from the golden"
        assert decided > 0, f"{name}: the device decided no reads"

    argv, sam, mst, pg = golden_argv("reads", ("reads_1.fq",), idx, out_dir)
    want_sam = hashlib.md5(gzip.open(os.path.join(
        GOLDEN, "reads.sam.gz")).read()).hexdigest()
    from abismal_tpu.map import pipeline

    for label, extra, env in (
            ("--engine hybrid", ["--engine", "hybrid",
                                 "--device-share", "0.5"], {}),
            ("--engine tpu-replay", ["--engine", "tpu-replay"], {}),
            ("--engine tpu --device-align (event-stream path)",
             ["--engine", "tpu", "--device-align"],
             {"ABISMAL_TPU_STAGE2": "0"})):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            dt = run_cli(extra + ["-t", str(ctx["threads"])] + argv)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        engs = [e for _, e in pipeline._engine_memo.values()]
        eng = engs[-1] if engs else None
        got = sam_md5_vs_golden(sam, pg)
        extra_info = ""
        if eng is not None and hasattr(eng, "n_device_aligned") \
                and "--device-align" in extra:
            extra_info = f", device-aligned jobs {eng.n_device_aligned}"
            assert eng.n_device_aligned > 0, "device align scored no jobs"
        log(f"[2] {label} on the SE golden: {dt:.1f}s, SAM md5 {got}, "
            f"device fallback {fallback_of(eng)}{extra_info}")
        assert got == want_sam, f"{label}: output differs from the golden"


# --- phase 3 ---------------------------------------------------------------

def scale_setup(ctx, args):
    """Generates the genome, builds its index on the host, simulates the
    reads; returns (index, genome path, se fq, pe fq1, pe fq2)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from scale_test import gen_genome

    from abismal_tpu.index.build import create_index
    from abismal_tpu.sim.simreads import SimConfig, simulate_reads

    fa = os.path.join(WORK, f"genome_{args.genome_size}.fa")
    t0 = time.perf_counter()
    gen_genome(fa, args.genome_size, seed=11)
    log(f"[3] generated a {args.genome_size / 1e9:.3f} Gb genome (seed 11) "
        f"in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    index = create_index(fa, n_threads=ctx["threads"])
    ctx["index_build_s"] = time.perf_counter() - t0
    log(f"[3] index build (native, {ctx['threads']} threads): "
        f"{ctx['index_build_s']:.1f}s  [{ctx['card']}]")
    t0 = time.perf_counter()
    pre = os.path.join(WORK, "scale")
    simulate_reads(fa, SimConfig(
        output_prefix=pre + "_se", n_reads=args.se_reads,
        mutation_rate=0.01, bs_conv=0.98, seed=7, single_end=True))
    simulate_reads(fa, SimConfig(
        output_prefix=pre + "_pe", n_reads=args.pe_pairs,
        mutation_rate=0.01, bs_conv=0.98, seed=11, single_end=False))
    log(f"[3] simulated {args.se_reads} SE reads and {args.pe_pairs} PE "
        f"pairs in {time.perf_counter() - t0:.1f}s")
    return (index, fa, pre + "_se_1.fq", pre + "_pe_1.fq",
            pre + "_pe_2.fq")


def map_timed(index, fq1, fq2, sam, factory, threads):
    from abismal_tpu.map.engine import run_map

    t0 = time.perf_counter()
    run_map(index, fq1, fq2, sam, None, "map scale smoke",
            engine_factory=factory, threads=threads)
    return time.perf_counter() - t0


def head_fastq(src: str, dst: str, n: int) -> str:
    with open(src, "rb") as f, open(dst, "wb") as g:
        for i, line in enumerate(f):
            if i >= 4 * n:
                break
            g.write(line)
    return dst


def phase3(ctx, args):
    import numpy as np

    import jax

    from abismal_tpu.map.pipeline import (
        DeviceIndex, TpuNativeEngine, make_native_engine_factory,
    )

    index, _fa, se_fq, pe1, pe2 = scale_setup(ctx, args)
    thr = ctx["threads"]
    card = ctx["card"]

    t0 = time.perf_counter()
    dev = DeviceIndex(index)
    for t in dev.tables():
        t.block_until_ready()
    up_s = time.perf_counter() - t0
    nbytes = sum(int(t.nbytes) for t in dev.tables())
    log(f"[3] table upload: {nbytes} bytes in {up_s:.2f}s  [{card}]")
    eng = TpuNativeEngine(index, lmax=LMAX, n_threads=thr, device_index=dev)

    def dev_factory(*_a):
        return eng

    dev_factory.is_native = True
    nat_factory = make_native_engine_factory(n_threads=thr)
    results = {}
    for kind, fq1, fq2, n in (("SE", se_fq, None, args.se_reads),
                              ("PE", pe1, pe2, args.pe_pairs)):
        unit = "reads/s" if kind == "SE" else "pairs/s"
        # first call: estimates the candidate budget from the first batch
        # and compiles the program
        w1 = head_fastq(fq1, os.path.join(WORK, f"warm_{kind}_1.fq"), 4096)
        w2 = (head_fastq(fq2, os.path.join(WORK, f"warm_{kind}_2.fq"), 4096)
              if fq2 else None)
        dt_c = map_timed(index, w1, w2, os.path.join(WORK, "warm.sam"),
                         dev_factory, thr)
        log(f"[3] {kind} device first call (compile + 4096 "
            f"{'reads' if kind == 'SE' else 'pairs'}): {dt_c:.1f}s  [{card}]")
        fb0, nu0 = eng.n_fallback, eng.n_units
        sam_d = os.path.join(WORK, f"scale_{kind}_device.sam")
        sam_n = os.path.join(WORK, f"scale_{kind}_native.sam")
        dt_d = map_timed(index, fq1, fq2, sam_d, dev_factory, thr)
        dt_n = map_timed(index, fq1, fq2, sam_n, nat_factory, thr)
        fb = (eng.n_fallback - fb0) / max(1, eng.n_units - nu0)
        same = md5_file(sam_d) == md5_file(sam_n)
        results[kind] = (n / dt_d, n / dt_n)
        log(f"[3] {kind}: device {n / dt_d:.1f} {unit}, native "
            f"{n / dt_n:.1f} {unit} ({thr} threads), device fallback "
            f"{fb:.5f}, SAM byte-identical: {same}  [{card}]")
        assert same, f"{kind}: device SAM differs from the native SAM"
        assert eng.n_units - nu0 > (eng.n_fallback - fb0), \
            f"{kind}: the device decided no reads"
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[3] peak_bytes_in_use {stats.get('peak_bytes_in_use')}  [{card}]")
    ctx["scale"] = results
    del eng, dev
    np.asarray(0)


# --- the four-GPU path ------------------------------------------------------

def open_devices(ctx):
    """Starts JAX on this process's devices and records the platform."""
    import jax

    devs = jax.devices()
    ctx["platform"] = devs[0].platform
    log(f"[0] jax {jax.__version__}, devices {devs}")
    return devs


def phase_four(ctx, args):
    from abismal_tpu.index.serialize import write_index
    from abismal_tpu.map.pipeline import (
        TpuNativeEngine, make_native_engine_factory,
    )

    index, _fa, se_fq, pe1, pe2 = scale_setup(ctx, args)
    thr = ctx["threads"]
    nat_factory = make_native_engine_factory(n_threads=thr)
    truth = {}
    for kind, fq1, fq2 in (("SE", se_fq, None), ("PE", pe1, pe2)):
        sam = os.path.join(WORK, f"four_{kind}_native.sam")
        dt = map_timed(index, fq1, fq2, sam, nat_factory, thr)
        truth[kind] = md5_file(sam)
        log(f"[4] native {kind}: {dt:.1f}s")

    # --hosts 4 --engine tpu through the CLI: four spawned shard processes,
    # each pinned to its own card; this process has not started JAX yet
    idx_path = os.path.join(WORK, "scale.idx")
    write_index(index, idx_path)
    sam = os.path.join(WORK, "four_SE_hosts.sam")
    dt = run_cli(["--engine", "tpu", "--hosts", "4", "-t",
                  str(max(1, thr // 4)), "-i", idx_path, "-o", sam, se_fq])
    same = md5_without_pg(sam) == md5_without_pg(
        os.path.join(WORK, "four_SE_native.sam"))
    log(f"[4] --hosts 4 --engine tpu SE: {dt:.1f}s (four processes, "
        f"compile included), SAM byte-identical to native apart from the "
        f"@PG line: {same}  [{ctx['card']}]")
    assert same, "--hosts 4 SE: SAM differs from native"
    os.unlink(idx_path)

    if len(open_devices(ctx)) < 4:
        raise RuntimeError("--four needs 4 devices")
    for label, kw, kinds in (("--mesh 4", dict(mesh_devices=4), ("SE", "PE")),
                             ("--index-shards 4", dict(index_shards=4),
                              ("SE",))):
        eng = TpuNativeEngine(index, lmax=LMAX, n_threads=thr, **kw)

        def fac(*_a, eng=eng):
            return eng

        fac.is_native = True
        for kind in kinds:
            fq1, fq2 = (se_fq, None) if kind == "SE" else (pe1, pe2)
            sam = os.path.join(WORK, f"four_{kind}_device.sam")
            dt_c = map_timed(index, fq1, fq2, sam, fac, thr)
            same = md5_file(sam) == truth[kind]
            log(f"[4] {label} {kind}: {dt_c:.1f}s (first call, compile "
                f"included), device fallback {fallback_of(eng)}, SAM "
                f"byte-identical to native: {same}  [{ctx['card']}]")
            assert same, f"{label} {kind}: SAM differs from native"
        del eng


# --- driver ----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU --hosts 4 / --mesh 4 / "
                         "--index-shards 4 paths and their native "
                         "comparison")
    ap.add_argument("--genome-size", type=int, default=DEFAULT_GENOME)
    ap.add_argument("--se-reads", type=int, default=200_000)
    ap.add_argument("--pe-pairs", type=int, default=50_000)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "abismal_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(WORK, exist_ok=True)
    ctx = {"threads": os.cpu_count() or 1}
    failed = []

    # phase 0: the device
    try:
        import jax

        from abismal_tpu.map.pipeline import configure_compile_cache
        from abismal_tpu.native import get_engine_lib, get_lib

        cache = configure_compile_cache(jax)
        ctx["card"] = card_line()
        if not args.four:  # --four opens the devices after its --hosts run
            open_devices(ctx)
        log(f"[0] compile cache: {cache}")
        t0 = time.perf_counter()
        get_lib()
        get_engine_lib()
        log(f"[0] native libraries ready in {time.perf_counter() - t0:.1f}s")
        log(f"[0] card: {ctx['card']}")
    except Exception:
        traceback.print_exc()
        print("phase 0 failed", file=sys.stderr)
        return 1
    if args.four:
        from abismal_tpu.parallel.multihost import visible_cards

        n_cards = len(visible_cards())
        no_gpu = n_cards < 4
        if no_gpu:
            log(f"[0] --four needs 4 GPUs, nvidia-smi lists {n_cards}")
    else:
        no_gpu = ctx["platform"] != "gpu"
        if no_gpu:
            log(f"[0] no GPU found: JAX platform is {ctx['platform']!r}")
    if no_gpu:
        failed.append("0")
        if args.genome_size > REHEARSAL_MAX_GENOME:
            print("no GPU found; a CPU rehearsal needs --genome-size <= "
                  f"{REHEARSAL_MAX_GENOME}", file=sys.stderr)
            return 1

    if args.four:
        phases = [("4", phase_four)]
    else:
        phases = [("1", phase1), ("2", phase2), ("3", phase3)]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(ctx, args)
            log(f"[{name}] phase {name} passed in "
                f"{time.perf_counter() - t0:.1f}s")
        except Exception:
            traceback.print_exc()
            log(f"[{name}] phase {name} FAILED")
            failed.append(name)
            if name == "1" and "trex1_idx" not in ctx:
                break  # later phases need the tRex1 index
    shutil.rmtree(WORK, ignore_errors=True)
    if failed:
        print(f"failed phases: {','.join(failed)}", file=sys.stderr)
        return 1
    d = jax.devices()
    if d[0].platform != "gpu":
        print(f"no GPU: JAX platform is {d[0].platform!r}", file=sys.stderr)
        return 1
    log(f"card: {ctx['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
