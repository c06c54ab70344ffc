"""Command-line interface mirroring `abismal {map, idx, sim}`
(reference: src/abismal_main.cpp, src/abismal.cpp:2295-2504,
src/abismalidx.cpp, src/simreads.cpp:442-619).

Options accept single- or double-dash long names and the reference's short
names.  The SAM @PG CL: header records argv exactly as the reference does
(the subcommand plus its arguments).
"""

from __future__ import annotations

import argparse
import sys
import time


class _DashArgumentParser(argparse.ArgumentParser):
    """Accepts reference-style single-dash long options (-seed, -single)."""

    def _get_option_tuples(self, option_string):
        if option_string.startswith("-") and not option_string.startswith("--"):
            alt = "--" + option_string[1:]
            if alt in self._option_string_actions:
                action = self._option_string_actions[alt]
                return [(action, alt, None, None)]
        return super()._get_option_tuples(option_string)

    def parse_known_args(self, args=None, namespace=None):
        if args is None:
            args = sys.argv[1:]
        args = [
            ("--" + a[1:]) if (
                len(a) > 2 and a.startswith("-") and not a.startswith("--")
                and ("--" + a[1:]) in self._option_string_actions
            ) else a
            for a in args
        ]
        return super().parse_known_args(args, namespace)


def _log(msg: str) -> None:
    print(f"[{time.asctime()}] {msg}", file=sys.stderr)


def cmd_idx(argv):
    p = _DashArgumentParser(prog="abismal-tpu idx")
    p.add_argument("-A", "--targets", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("genome_fasta")
    p.add_argument("index_file")
    a = p.parse_args(argv)

    from .index.build import create_index, create_index_targets
    from .index.serialize import write_index

    if a.targets:
        idx = create_index_targets(a.targets, a.genome_fasta,
                                   verbose=a.verbose, n_threads=a.threads)
    else:
        idx = create_index(a.genome_fasta, verbose=a.verbose,
                           n_threads=a.threads)
    write_index(idx, a.index_file)
    return 0


def cmd_sim(argv):
    p = _DashArgumentParser(prog="abismal-tpu sim")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--single", action="store_true")
    p.add_argument("--loc", default="")
    p.add_argument("-l", "--read-len", type=int, default=100)
    p.add_argument("--min-fraglen", type=int, default=100)
    p.add_argument("--max-fraglen", type=int, default=250)
    p.add_argument("-n", "--n-reads", type=int, default=100)
    p.add_argument("-m", "--mut", type=float, default=0.0)
    p.add_argument("-b", "--bis", type=float, default=1.0)
    p.add_argument("-c", "--changes", default="")
    p.add_argument("-M", "--max-mut", type=int, default=None,
                   help="accepted for compatibility; unused upstream too")
    p.add_argument("-a", "--pbat", action="store_true")
    p.add_argument("-R", "--random-pbat", action="store_true")
    p.add_argument("-s", "--strand", default="b")
    p.add_argument("--show-matches", dest="show_matches",
                   action="store_false", default=True,
                   help="toggle match symbols in loc cigars off (the "
                        "reference's bool options toggle their default)")
    p.add_argument("--require-valid", action="store_true",
                   help="resample fragments per the reference's "
                        "require-valid loop (RNG-consumption compatible)")
    p.add_argument("--fasta", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("genome_fasta")
    a = p.parse_args(argv)

    from .sim.simreads import SimConfig, simulate_reads

    sub, ins, dele = 1.0, 1.0, 1.0
    if a.changes:
        parts = a.changes.split(",")
        sub, ins, dele = (float(parts[0]), float(parts[1]), float(parts[2]))
    seed = a.seed if a.seed is not None else int(time.time())
    cfg = SimConfig(
        output_prefix=a.out, n_reads=a.n_reads, read_length=a.read_len,
        min_frag_len=a.min_fraglen, max_frag_len=a.max_fraglen,
        mutation_rate=a.mut, substitution_rate=sub, insertion_rate=ins,
        deletion_rate=dele, bs_conv=a.bis, strand=a.strand, pbat=a.pbat,
        random_pbat=a.random_pbat, single_end=a.single, fasta_format=a.fasta,
        show_cigar_matches=a.show_matches, require_valid=a.require_valid,
        locations_file=a.loc, seed=seed,
    )
    simulate_reads(a.genome_fasta, cfg)
    return 0


def cmd_map(argv):
    p = _DashArgumentParser(prog="abismal-tpu map")
    p.add_argument("-i", "--index", default="")
    p.add_argument("-g", "--genome", default="")
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("-B", "--bam", action="store_true")
    p.add_argument("-s", "--stats", default="")
    p.add_argument("-j", "--json", action="store_true")
    p.add_argument("-c", "--max-candidates", type=int, default=0)
    p.add_argument("-l", "--min-frag", type=int, default=32)
    p.add_argument("-L", "--max-frag", type=int, default=3000)
    p.add_argument("-m", "--max-distance", type=float, default=0.1)
    p.add_argument("-a", "--ambig", action="store_true")
    p.add_argument("-P", "--pbat", action="store_true")
    p.add_argument("-R", "--random-pbat", action="store_true")
    p.add_argument("-A", "--a-rich", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--engine",
                   choices=["native", "tpu", "hybrid", "exact",
                            "tpu-replay"],
                   default="native",
                   help="mapping engine: native (C++ host, default), tpu "
                        "(device stage-1+2 + native finalize), hybrid "
                        "(native AND tpu engines on disjoint read shards "
                        "concurrently; their throughputs add), exact "
                        "(Python oracle), tpu-replay (device stage-1 + "
                        "Python replay; debugging)")
    p.add_argument("--device-share", dest="device_share", type=float,
                   default=None,
                   help="--engine hybrid: fraction of reads routed to the "
                        "accelerator (default $ABISMAL_DEVICE_SHARE or "
                        "0.15; pick ~= dev_rate / (dev_rate + host_rate))")
    p.add_argument("--lmax", type=int, default=128,
                   help="padded read length for the device pipeline; reads "
                        "longer than this use the host path")
    p.add_argument("--device-align", dest="device_align", default=None,
                   action="store_true",
                   help="score candidate alignments on the accelerator on "
                        "the event-stream path (--engine tpu with "
                        "ABISMAL_TPU_STAGE2=0; the default fused path "
                        "always scores on the device)")
    p.add_argument("--mesh", default=None,
                   help="shard unit batches over N local devices with the "
                        "index replicated per chip (--engine tpu; "
                        "an integer or 'all')")
    p.add_argument("--index-shards", dest="index_shards", default=None,
                   help="shard the index position lists by bucket-key "
                        "range over N local devices (TP layout; --engine "
                        "tpu; an integer or 'all')")
    p.add_argument("--hosts", type=int, default=0,
                   help="multi-host run: shard the FASTQ by read range "
                        "over N host processes (each loads its own index "
                        "replica) and gather shard SAMs in rank order; "
                        "output is byte-identical to a single-host run "
                        "(requires -i)")
    p.add_argument("--shard", default="",
                   help="map only read-range shard I:N of the input (one "
                        "host of a real multi-host run; the header is "
                        "written by shard 0 only; concatenate shard "
                        "outputs in rank order to gather)")
    p.add_argument("reads_files", nargs="+")
    a = p.parse_args(argv)

    if bool(a.index) == bool(a.genome):
        print("Select one of index file (-i) or genome file (-g)",
              file=sys.stderr)
        return 0
    if len(a.reads_files) > 2:
        print("expected <reads-fq1> [<reads-fq2>]", file=sys.stderr)
        return 0
    if a.engine in ("tpu", "tpu-replay") and a.lmax < 64:
        print("--lmax must be at least 64", file=sys.stderr)
        return 1

    from .index.serialize import read_index
    from .map.engine import run_map

    command_line = "map " + " ".join(argv)
    reads2 = a.reads_files[1] if len(a.reads_files) == 2 else None

    if a.hosts or a.shard:
        # multi-host sharding: every host process loads its own index
        # replica, so the coordinator never loads one
        if not a.index:
            print("--hosts/--shard require a prebuilt index (-i)",
                  file=sys.stderr)
            return 0
        if a.engine not in ("native", "tpu"):
            print(f"--engine {a.engine} is not supported with "
                  "--hosts/--shard: shard processes run the native or tpu "
                  "engine", file=sys.stderr)
            return 1
        from .map.engine import _write_stats

        paired = reads2 is not None
        if a.hosts:
            from .parallel.multihost import run_map_multihost

            # one card per device shard process (shard_device_envs); the
            # coordinator itself never starts JAX
            stats = run_map_multihost(
                a.index, a.reads_files[0], reads2, a.outfile, command_line,
                n_hosts=a.hosts, threads_per_host=max(1, a.threads),
                a_rich=a.a_rich, pbat=a.pbat, random_pbat=a.random_pbat,
                allow_ambig=a.ambig, valid_frac=a.max_distance,
                pe_min_dist=a.min_frag, pe_max_dist=a.max_frag,
                bam=a.bam, verbose=a.verbose, engine=a.engine)
        else:
            from .parallel.multihost import (
                count_reads, map_shard, shard_bounds, _apply_stats,
            )
            from .map.stats import PEStats, SEStats

            si, sn = a.shard.split(":")
            si, sn = int(si), int(sn)
            skip, cnt = shard_bounds(count_reads(a.reads_files[0]), sn)[si]
            raw = map_shard(
                a.index, a.reads_files[0], reads2, a.outfile, si, sn,
                command_line, skip, cnt, a_rich=a.a_rich, pbat=a.pbat,
                random_pbat=a.random_pbat, allow_ambig=a.ambig,
                valid_frac=a.max_distance, pe_min_dist=a.min_frag,
                pe_max_dist=a.max_frag, threads=max(1, a.threads),
                bam=a.bam, verbose=a.verbose, engine=a.engine)
            stats = PEStats() if paired else SEStats()
            _apply_stats(raw, paired, stats)
        _write_stats(stats, a.stats or None, a.json, paired, a.ambig)
        return 0

    if a.engine in ("tpu", "tpu-replay", "hybrid"):
        from .map.pipeline import device_backend

        try:
            device_backend()
        except RuntimeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1

    if a.index:
        if a.verbose:
            _log(f"loading index {a.index}")
        index = read_index(a.index)
    else:
        if a.verbose:
            _log(f"indexing genome {a.genome}")
        from .index.build import create_index

        index = create_index(a.genome)
    if a.max_candidates:
        index.max_candidates = a.max_candidates

    if a.engine == "hybrid":
        from .map.engine import _write_stats
        from .map.hybrid_split import (
            NativeShardServer,
            run_map_hybrid_split,
        )

        paired = reads2 is not None
        # with a prebuilt index (-i) the host shard gets its own pristine
        # worker process (the native engine is measurably slower inside
        # the accelerator-runtime process); otherwise it runs in-process
        server = None
        if a.index:
            server = NativeShardServer(
                a.index, a.ambig, a.max_distance, a.min_frag, a.max_frag,
                threads=max(1, a.threads))
        try:
            stats = run_map_hybrid_split(
                index, a.reads_files[0], reads2, a.outfile, command_line,
                device_share=a.device_share, threads=max(1, a.threads),
                a_rich=a.a_rich, pbat=a.pbat, random_pbat=a.random_pbat,
                allow_ambig=a.ambig, valid_frac=a.max_distance,
                pe_min_dist=a.min_frag, pe_max_dist=a.max_frag,
                lmax=a.lmax, bam=a.bam, verbose=a.verbose,
                native_server=server)
        finally:
            if server is not None:
                server.close()
        _write_stats(stats, a.stats or None, a.json, paired, a.ambig)
        return 0

    engine_factory = None
    if a.engine == "native":
        from .map.pipeline import make_native_engine_factory

        engine_factory = make_native_engine_factory(n_threads=a.threads)
    elif a.engine == "tpu":
        from .map.pipeline import make_tpu_native_engine_factory

        mesh = a.mesh
        if mesh is not None and mesh != "all":
            mesh = int(mesh)
        ishards = a.index_shards
        if ishards is not None and ishards != "all":
            ishards = int(ishards)
        engine_factory = make_tpu_native_engine_factory(
            lmax=a.lmax, n_threads=a.threads, mesh_devices=mesh,
            device_align=a.device_align, index_shards=ishards)
    elif a.engine == "tpu-replay":
        from .map.pipeline import make_tpu_engine_factory

        engine_factory = make_tpu_engine_factory(lmax=a.lmax)

    run_map(
        index, a.reads_files[0], reads2, a.outfile,
        a.stats or None, command_line, a_rich=a.a_rich, pbat=a.pbat,
        random_pbat=a.random_pbat, allow_ambig=a.ambig, stats_json=a.json,
        valid_frac=a.max_distance, pe_min_dist=a.min_frag,
        pe_max_dist=a.max_frag, engine_factory=engine_factory,
        threads=a.threads, bam=a.bam, verbose=a.verbose,
    )
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Program: abismal-tpu\nUsage: abismal-tpu <command> [options]\n"
              "Commands:\n    map:    map FASTQ reads to an index or a FASTA "
              "reference genome\n    idx:    make an index for a FASTA "
              "reference genome\n    sim:    simulate WGBS reads for a FASTA "
              "reference genome")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "map":
        return cmd_map(rest)
    if cmd == "idx":
        return cmd_idx(rest)
    if cmd == "sim":
        return cmd_sim(rest)
    print(f"ERROR: invalid command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
