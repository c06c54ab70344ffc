"""Multi-host mapping: FASTQ read-range sharding + ordered SAM gather.

The scale-out design from SURVEY 2.5: reads are embarrassingly parallel
over a read-only index, so each host maps a contiguous READ-RANGE shard of
the shared FASTQ against its own index replica and writes a shard SAM; the
gather step concatenates shards in rank order and sums the statistics
counters (the reference's atomic-counter equivalent over DCN).  Output is
byte-identical to a single-host run at any host count, unlike the
reference's `-t` which loses output determinism.

Each "host" here is a spawned process that loads the index from disk
itself -- the same code runs on real separate machines with a shared
filesystem (or a FASTQ copy) by invoking `map --shard I:N` per host and
`gather` afterwards; nothing is exchanged between hosts except the shard
files at gather time.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from ..io.genome import open_maybe_gzip

_SE_FIELDS = ("total_reads", "reads_mapped_unique", "reads_mapped_ambiguous",
              "reads_skipped", "edit_distance", "total_bases")


def count_reads(fastq_path: str) -> int:
    """Number of FASTQ records (lines / 4), gz-aware.  A final line with
    no trailing newline still counts (the native parser accepts it)."""
    n = 0
    last = b"\n"
    with open_maybe_gzip(fastq_path) as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            n += chunk.count(b"\n")
            last = chunk[-1:]
    if last != b"\n":
        n += 1
    return n // 4


def shard_bounds(total_reads: int, n_shards: int):
    """[(skip, count)] per shard; counts differ by at most one."""
    bounds = [(i * total_reads) // n_shards for i in range(n_shards + 1)]
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(n_shards)]


def visible_cards() -> list[str]:
    """Ids of the GPUs this process may use, without starting JAX:
    CUDA_VISIBLE_DEVICES when it is set, else one id per card that
    `nvidia-smi -L` lists (none when nvidia-smi is missing)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    n = sum(1 for line in out.splitlines() if line.startswith("GPU "))
    return [str(i) for i in range(n)]


def shard_device_envs(n_shards: int, engine: str, platforms=None,
                      cards=None) -> list[dict]:
    """Environment each shard process applies before JAX starts: one card
    per device-engine shard (CUDA_VISIBLE_DEVICES), so no card is opened by
    two processes.  An explicit CPU run (JAX_PLATFORMS=cpu) pins nothing;
    more device shards than cards is an error, not a shared card."""
    if engine != "tpu":
        return [{} for _ in range(n_shards)]
    if platforms is None:
        platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms.strip().lower() == "cpu":
        return [{} for _ in range(n_shards)]
    if cards is None:
        cards = visible_cards()
    if n_shards > len(cards):
        raise ValueError(
            f"--hosts {n_shards} --engine tpu needs one GPU per shard "
            f"process, but {len(cards)} are visible")
    return [{"CUDA_VISIBLE_DEVICES": cards[i]} for i in range(n_shards)]


def map_shard(index_path: str, reads_file1: str, reads_file2,
              out_shard: str, shard_i: int, n_shards: int,
              command_line: str, skip: int, count: int,
              a_rich=False, pbat=False, random_pbat=False,
              allow_ambig=False, valid_frac=0.1, pe_min_dist=32,
              pe_max_dist=3000, threads: int = 1, total_reads=None,
              bam: bool = False, verbose: bool = False,
              engine: str = "native", device_env=None):
    """One host's work: load the index replica, map reads [skip,
    skip+count), write records (rank 0 also writes the header).  Returns
    the shard's raw stats counters (6 ints SE, 18 PE).

    engine="tpu" runs the shard through the device stage-1+2 engine, so an
    N-host run drives N devices.  device_env (shard_device_envs) is
    applied to this process's environment first; it must run before JAX
    starts in this process, which run_map_multihost guarantees by giving
    every shard a fresh process.

    BAM shards: each shard is a complete BGZF stream (shard 0 additionally
    starts with the compressed header); concatenating the shards in rank
    order yields a valid BAM whose decompressed payload equals the
    single-host run's (the per-shard EOF markers are empty BGZF members,
    which BAM readers skip)."""
    import numpy as np

    os.environ.update(device_env or {})
    from ..index.serialize import read_index
    from ..io.sam import make_sam_header
    from ..map.native_engine import NativeMappingEngine, _ptr

    index = read_index(index_path)
    if engine == "tpu":
        from ..map.native_engine import run_map_pipelined
        from ..map.pipeline import TpuNativeEngine
        from ..map.stats import PEStats

        teng = TpuNativeEngine(index, allow_ambig, valid_frac, pe_min_dist,
                               pe_max_dist, n_threads=threads)
        stats = run_map_pipelined(
            teng, index, reads_file1, reads_file2, out_shard, command_line,
            a_rich=a_rich, pbat=pbat, random_pbat=random_pbat,
            bam=bam, verbose=verbose, skip=skip, count=count,
            write_header=(shard_i == 0))
        if isinstance(stats, PEStats):
            return [int(getattr(blk, f)) for blk in
                    (stats.read_pair_stats, stats.end1_stats,
                     stats.end2_stats) for f in _SE_FIELDS]
        return [int(getattr(stats, f)) for f in _SE_FIELDS]
    eng = NativeMappingEngine(index, allow_ambig, valid_frac, pe_min_dist,
                              pe_max_dist, n_threads=threads)
    header = (make_sam_header(index.cl, command_line) if shard_i == 0
              else "")
    paired = reads_file2 is not None
    a_rich_mode = (pbat if paired else (a_rich or pbat))
    st = np.zeros(18 if paired else 6, dtype=np.int64)
    if bam and shard_i == 0:
        from ..io.bam import bam_header_payload

        hdr = bam_header_payload(header)
    else:
        hdr = header.encode()
    if not paired:
        n = eng.lib.engine_run_se(
            eng._ctx, reads_file1.encode(), out_shard.encode(), hdr,
            len(hdr), int(a_rich_mode), int(random_pbat), 1000,
            eng.n_threads, _ptr(st), int(verbose), int(skip), int(count),
            int(bam))
    else:
        n = eng.lib.engine_run_pe(
            eng._ctx, reads_file1.encode(), reads_file2.encode(),
            out_shard.encode(), hdr, len(hdr), int(a_rich_mode),
            int(random_pbat), 1000, eng.n_threads, _ptr(st), int(verbose),
            int(skip), int(count), int(bam))
    if n < 0:
        raise RuntimeError(eng.lib.engine_error_ptr(eng._ctx).decode())
    return st.tolist()


def gather(shard_paths, out_path: str):
    """Concatenates shard SAM files in rank order (the DCN gather)."""
    with open(out_path, "wb") as out:
        for p in shard_paths:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, 1 << 22)


def _apply_stats(raw, paired, stats):
    if not paired:
        for i, f in enumerate(_SE_FIELDS):
            setattr(stats, f, getattr(stats, f) + int(raw[i]))
    else:
        for blk, dst in enumerate((stats.read_pair_stats, stats.end1_stats,
                                   stats.end2_stats)):
            for i, f in enumerate(_SE_FIELDS):
                setattr(dst, f, getattr(dst, f) + int(raw[6 * blk + i]))


def run_map_multihost(index_path: str, reads_file1: str, reads_file2,
                      out_path: str, command_line: str, n_hosts: int,
                      threads_per_host: int = 1, **map_kwargs):
    """Coordinator: shard by read count, run one process per host (each
    loads its own index replica -- no shared memory), gather shard SAMs
    in rank order, sum statistics.  Returns the merged stats object."""
    import multiprocessing as mp

    from ..map.stats import PEStats, SEStats

    paired = reads_file2 is not None
    total = count_reads(reads_file1)
    shards = shard_bounds(total, n_hosts)
    shard_paths = [f"{out_path}.shard{i}" for i in range(n_hosts)]
    verbose = bool(map_kwargs.pop("verbose", False))
    envs = shard_device_envs(n_hosts, map_kwargs.get("engine", "native"))
    ctx = mp.get_context("spawn")
    # one fresh process per shard (maxtasksperchild=1): a shard's device
    # pinning must take effect before JAX starts in its process
    with ctx.Pool(n_hosts, maxtasksperchild=1) as pool:
        results = [
            pool.apply_async(
                map_shard,
                (index_path, reads_file1, reads_file2, shard_paths[i], i,
                 n_hosts, command_line, skip, cnt),
                # progress output from rank 0 only (the shards' stderr
                # streams would interleave)
                dict(threads=threads_per_host, device_env=envs[i],
                     verbose=(verbose and i == 0), **map_kwargs))
            for i, (skip, cnt) in enumerate(shards)
        ]
        raws = [r.get() for r in results]
    stats = PEStats() if paired else SEStats()
    for raw in raws:
        _apply_stats(raw, paired, stats)
    gather(shard_paths, out_path)
    for p in shard_paths:
        os.unlink(p)
    return stats
