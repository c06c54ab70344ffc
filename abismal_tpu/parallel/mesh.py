"""Multi-device execution: read-batch data parallelism over a device mesh.

The reference scales by N identical worker threads pulling read batches from
a shared queue (abismal.cpp:2187-2263).  The device equivalent shards the
unit batch across a plain 1-D mesh axis ("data") over jax.devices(), with
the index tables replicated in every device's memory; per-shard mapping
statistics are reduced with psum, mirroring the reference's atomic
counters.  Every device reaches every other at the same rate, so the mesh
follows the algorithm alone.  Host I/O distributes
FASTQ shards and gathers SAM output in global read order, which keeps output
deterministic (the reference loses determinism at t>1).
"""

from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def shard_stage1(stage1, mesh):
    """Wraps a stage-1 callable in shard_map: unit-batch arrays sharded on
    the mesh's data axis, index tables replicated, plus a psum'd event-count
    reduction (the statistics collective)."""
    import jax
    from jax.sharding import PartitionSpec as P

    rep = P()
    sh = P("data")

    def wrapped(tables, preads, lens, is_ga, thr):
        def inner(tables, preads, lens, is_ga, thr):
            ev, cf = stage1(*tables, preads, lens, is_ga, thr)
            count = cf & 0x3FFFFFFF
            total_events = jax.lax.psum(count.sum(), "data")
            return ev, cf, total_events

        return jax.shard_map(
            inner, mesh=mesh,
            in_specs=(rep, sh, sh, sh, sh),
            out_specs=(P("data", None), sh, rep),
            check_vma=False,
        )(tables, preads, lens, is_ga, thr)

    return jax.jit(wrapped)


def shard_stage12(stage12, mesh):
    """Wraps the fused SE stage-1+2 program in shard_map: unit/read arrays
    sharded on the data axis, index tables replicated, ONE record per read
    out -- plus the psum'd per-status decision counts (unmapped/exact/
    aligned/fallback), the real-statistics collective (SURVEY 2.5: the
    reference's atomic counters ride psum here, not a token event count)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    rep = P()
    sh = P("data")

    def wrapped(tables, pnib, lens, is_ga, scode, max_diffs_r):
        def inner(tables, pnib, lens, is_ga, scode, max_diffs_r):
            out = stage12(*tables, pnib, lens, is_ga, scode, max_diffs_r)
            rec = out[0] if isinstance(out, tuple) else out
            st = rec[:, 0] & 7
            counts = jnp.stack([jnp.sum(st == s) for s in range(4)])
            counts = jax.lax.psum(counts, "data")
            if isinstance(out, tuple):  # device traceback: + ops, meta
                return rec, out[1], out[2], counts
            return rec, counts

        # probe the output arity (rec alone, or rec + traceback ops/meta)
        # without running the device program
        probe = jax.eval_shape(
            lambda tb, *a: stage12(*tb, *a), tables, pnib, lens, is_ga,
            scode, max_diffs_r)
        n_out = len(probe) if isinstance(probe, tuple) else 1
        outs = (P("data", None),) * n_out + (rep,)
        return jax.shard_map(
            inner, mesh=mesh,
            in_specs=(rep, sh, sh, sh, rep, sh),
            out_specs=outs,
            check_vma=False,
        )(tables, pnib, lens, is_ga, scode, max_diffs_r)

    return jax.jit(wrapped)


def shard_stage12pe(stage12pe, mesh):
    """PE variant: per-unit candidate slot tables sharded out, with the
    psum'd fallback-unit count as the statistics collective."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    rep = P()
    sh = P("data")

    def wrapped(tables, pnib, lens, is_ga, max_diffs_u, pe_dist):
        def inner(tables, pnib, lens, is_ga, max_diffs_u, pe_dist):
            pk = stage12pe(*tables, pnib, lens, is_ga, max_diffs_u,
                           pe_dist)
            # packed row layout: [pos(K) | ds(K) | cnt | mate(5)]
            cnt = pk[:, (pk.shape[1] - 6) // 2 * 2]
            fb = jax.lax.psum(jnp.sum(cnt < 0), "data")
            return pk, fb

        return jax.shard_map(
            inner, mesh=mesh,
            in_specs=(rep, sh, sh, sh, sh, rep),
            out_specs=(P("data", None), rep),
            check_vma=False,
        )(tables, pnib, lens, is_ga, max_diffs_u, pe_dist)

    return jax.jit(wrapped)


def shard_stage1_tp(stage1, mesh):
    """Key-range-sharded index ("TP option", SURVEY 2.5): the position
    lists are sharded across the mesh by bucket-key range, the genome and
    counter tables are replicated, and the FULL unit batch is replicated
    so every shard probes the buckets it owns.  Each shard emits its own
    compacted event stream; streams are rank-merged on the host (each
    bucket lives on exactly one shard, so the merge reproduces the
    unsharded discovery order exactly)."""
    import jax
    from jax.sharding import PartitionSpec as P

    rep = P()
    sh = P("data")

    def wrapped(genome32, genome2o, counter2, counter3, index_local,
                shardinfo, preads, lens, is_ga, thr):
        def inner(genome32, genome2o, counter2, counter3, index_local,
                  shardinfo, preads, lens, is_ga, thr):
            ev, cf = stage1(genome32, genome2o, counter2, counter3,
                            index_local[0], preads, lens, is_ga, thr,
                            shard=shardinfo[0])
            return ev, cf[None, :]

        return jax.shard_map(
            inner, mesh=mesh,
            in_specs=(rep, rep, rep, rep, P("data", None), P("data", None),
                      rep, rep, rep, rep),
            out_specs=(P("data", None), P("data", None)),
            check_vma=False,
        )(genome32, genome2o, counter2, counter3, index_local, shardinfo,
          preads, lens, is_ga, thr)

    return jax.jit(wrapped)


def replicate_tables(dev_index, mesh):
    """Places the index tables with a replicated sharding over the mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    return tuple(jax.device_put(t, rep) for t in dev_index.tables())


def shard_units(arrays, mesh):
    """Places unit-batch arrays sharded along the data axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data"))
    return tuple(jax.device_put(a, sh) for a in arrays)
