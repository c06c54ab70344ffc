"""Device pipeline for candidate generation, filtering and alignment.

Design (batch-first, not a translation of the reference's per-read loops):
reads are batched into fixed-shape "units" (one per read x strand x
encoding); a single jitted device program computes, for every unit and every
seed offset, the rolling hash keys, the index bucket, the binary-search seed
extension over the suffix-sorted bucket, and the bisulfite-aware popcount
Hamming distance of every surviving candidate.  The fused stage-1+2
programs (build_stage12, build_stage12pe) go on to decide, score and trace
back on the device; the event-stream stage-1 program (build_stage1)
instead compacts accepted events (diffs <= 0.4*len, the largest cutoff
the sequential engine can ever apply) into a dense per-unit event list
that the host replays through the reference's sequential state machine
(candidate heap, adaptive cutoff, sure-ambig aborts; abismal.cpp:1269-1375).
Units whose candidate slots or buffers overflow fall back to the exact host
path, preserving bit-exactness unconditionally.

The genome is 4-bit packed into uint32 words (8 bases/word); all tables
live in device memory and are gathered under jit.  Multi-device operation
shards units across a mesh with the index replicated (see
parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    KEY_WEIGHT,
    KEY_WEIGHT_THREE,
    MIN_FOLD_SIZE,
    N_SORTING_POSITIONS,
    WINDOW_SIZE,
)

SLOT = 128  # max candidates checked per (offset, table); > max_candidates
HASH3_MOD = 43046721  # 3^16

# Minimum read length for the device paths.  The specific phase seeds
# offsets up to floor(len/2) (process_seeds, abismal.cpp:1298-1305), and a
# KEY_WEIGHT-symbol seed at that offset stays inside the read only when
# floor(len/2) + KEY_WEIGHT <= len, i.e. len >= 2*KEY_WEIGHT - 1 = 49;
# below that the reference reads past the read end (benign garbage
# upstream, unreproducible on fixed-shape device buffers).  The bound is
# profile-independent (KEY_WEIGHT does not change under ABISMAL_TPU_SHORT),
# so under the SHORT profile 36-48 bp reads -- its target workload -- map
# on the exact host path.
DEVICE_MIN_LEN = 2 * KEY_WEIGHT - 1  # 49


def auto_cand_budget(n_index2: int, n_index3: int, lmax: int) -> int:
    """Global per-unit candidate budget sized to the index's bucket
    density: large genomes have ~genome_size/2^25 positions per two-letter
    bucket, so the toy-genome default would dump every unit onto the host
    fallback path.  Clipped to keep the compiled gather pass bounded."""
    o_spec = o_spec_for(lmax)
    o_sens = lmax - KEY_WEIGHT + 1
    avg2 = n_index2 / float(1 << KEY_WEIGHT)
    avg3 = n_index3 / float(HASH3_MOD)
    est = int((avg2 + avg3) * (o_spec + o_sens) * 8)
    # the budget is POOLED over the unit batch (global prefix sums), so a
    # few-x margin over the measured mean suffices: tRex1 means 11.4
    # candidates/unit (est = 34); compare/list cost scales linearly with
    # the padded pool, so a tight floor is a direct speedup
    return max(64, min(8192, (est + 63) & ~63))


def o_spec_for(lmax: int) -> int:
    """Static specific-phase offset bound for a padded read length."""
    return max(WINDOW_SIZE, lmax >> 1)


def estimate_cand_budget(counters, max_candidates: int, units, is_ga,
                         lmax: int, sample: int = 512) -> int:
    """Workload-informed per-unit candidate budget: replays the seeding
    policy's bucket-size checks in NumPy over a sample of real units
    (keys via rolling hashes, sizes via the counter prefix arrays) and
    sizes the POOLED device budget at ~1.1x the measured mean.  Returns
    (budget, ext_lanes_per_unit): the second term is the measured mean
    of oversized specific-phase buckets per unit, from which the engine
    sizes the extension pool (None when no units were measurable).

    Every per-candidate device op scales with the pooled budget, so
    overshooting it costs time linearly; the density heuristic
    (auto_cand_budget) overshoots up to 12x at GB scale because indexed-
    position counts say little about read-weighted bucket sizes.  The
    pooled budget makes the margin safe: units past the pool fall back to
    the exact host path (overflow flag), so an underestimate costs speed,
    never correctness."""
    from .seeds import read_hashes

    c2, ct, ca = (c.astype(np.int64) for c in counters)
    mc = max_candidates
    tot = 0.0
    ext_tot = 0.0
    n = 0
    step = max(1, len(units) // sample)
    for i in range(0, len(units), step):
        u = units[i]
        rl = int(u.shape[0])
        if rl < KEY_WEIGHT + WINDOW_SIZE - 1:
            continue
        k2, k3t, k3a = read_hashes(u)
        k3 = k3a if is_ga[i] else k3t
        c3 = ca if is_ga[i] else ct
        s2 = c2[k2 + 1] - c2[k2]
        s3 = c3[k3 + 1] - c3[k3]
        o_sp = min(max(WINDOW_SIZE, rl >> 1), o_spec_for(lmax))
        # specific phase: small buckets checked as-is, oversized ones
        # extension-capped at SLOT (upper bound; most narrow below mc)
        est = (np.minimum(s2[:o_sp], SLOT).sum()
               + np.minimum(s3[:o_sp], SLOT).sum())
        # sensitive phase: only small buckets; the 2-letter fold rule
        # (d2 <= 10*d3) is ignored (upper bound)
        est += s2[(s2 <= mc)].sum() + s3[(s3 <= mc)].sum()
        tot += float(est)
        # oversized specific-phase buckets are the extension pool's
        # demand (one lane each); measured 0.01/unit at a 1 GB index vs
        # the 512-lane static default, and every bisection probe costs
        # vector lanes proportional to the pool
        ext_tot += float((s2[:o_sp] > mc).sum() + (s3[:o_sp] > mc).sum())
        n += 1
    if n == 0:
        return 64, None
    mean = tot / n
    # the pool is GLOBAL over the batch, so the margin only covers batch-
    # to-batch drift of the mean (not per-unit variance; over a 2048-unit
    # chunk the mean's std is <1% of itself), and every per-candidate op
    # scales with the pool size -- 1.1x is the margin kept; spills cost an
    # exact host remap of tail units, never correctness
    return (int(min(8192, max(64, (int(mean * 1.10) + 15) & ~15))),
            ext_tot / n)

_jax = None
_jnp = None


import os
import time

# compile cache used when JAX_COMPILATION_CACHE_DIR is not set: one fixed
# path inside the checkout (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache(jax) -> str:
    """Points JAX's persistent compile cache at DEFAULT_CACHE_DIR unless
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that itself).  Returns the
    directory in use."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return cache_dir


def device_backend(backend: str | None = None,
                   platforms: str | None = None) -> str:
    """The one place the device engine picks where its programs run.

    Returns "gpu" when JAX's backend is the GPU (kernels are compiled
    there), and "cpu" only when the CPU platform was asked for explicitly
    (JAX_PLATFORMS=cpu; kernels then run in Pallas interpret mode).  Any
    other case -- above all a CPU backend that JAX fell back to because it
    found no GPU -- raises, so the device engine never runs on the CPU
    without saying so.  The arguments default to JAX's own backend and
    platforms setting."""
    jax, _ = _jm()
    if backend is None:
        backend = jax.default_backend()
    if platforms is None:
        platforms = jax.config.jax_platforms or ""
    if backend == "gpu":
        return "gpu"
    if backend == "cpu" and platforms.strip().lower() == "cpu":
        return "cpu"
    raise RuntimeError(
        f"the device engine needs a GPU, but JAX's backend is {backend!r} "
        f"(JAX_PLATFORMS={platforms!r}); set JAX_PLATFORMS=cpu to run it "
        "on the CPU in interpret mode, or use --engine native")


def interpret_kernels() -> bool:
    """Pallas kernels run in interpret mode iff the backend is an
    explicitly requested CPU (device_backend)."""
    return device_backend() == "cpu"


def _jm():
    global _jax, _jnp
    if _jax is None:
        import jax
        import jax.numpy as jnp

        configure_compile_cache(jax)
        _jax = jax
        _jnp = jnp
    return _jax, _jnp


_stage1_memo = {}


def pack_genome_u32(genome_words_u64: np.ndarray, guard: int = 64):
    """Split the u64-packed genome into u32 words (8 bases each), little
    nibble order preserved, plus zero guard words for gather safety."""
    lo = (genome_words_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (genome_words_u64 >> np.uint64(32)).astype(np.uint32)
    out = np.empty(genome_words_u64.shape[0] * 2 + guard, dtype=np.uint32)
    out[0 : 2 * genome_words_u64.shape[0] : 2] = lo
    out[1 : 2 * genome_words_u64.shape[0] : 2] = hi
    out[2 * genome_words_u64.shape[0]:] = 0
    return out


def overlap_rows_u32(genome32: np.ndarray) -> np.ndarray:
    """2x-overlapped aligned row view of the packed genome: row r holds
    words [64r, 64r+128), so any <= 65-word window lives in ONE row and
    the per-candidate window fetch is a single aligned-row gather.  The
    128-word width is not measured against the GPU's 32-byte sectors
    (ROADMAP A2)."""
    n = genome32.shape[0]
    rows = (n + 63) // 64 + 2  # +2 guard rows: long-read jobs splice ahead
    pad = np.zeros(rows * 64 + 128, dtype=np.uint32)
    pad[:n] = genome32
    a = pad[: rows * 64].reshape(rows, 64)
    b = pad[64 : rows * 64 + 64].reshape(rows, 64)
    return np.concatenate([a, b], axis=1)


def counter_pairs(counter: np.ndarray) -> np.ndarray:
    """(N+1,) bucket-offset prefix array -> (N, 2) aligned (start, end)
    rows: bucket k's range always needs counter[k] AND counter[k+1], so
    one pair-row gather replaces two element gathers.  i32 with modular
    wrap, matching the TP rebase arithmetic."""
    c = counter.astype(np.int32)
    return np.ascontiguousarray(np.stack([c[:-1], c[1:]], axis=1))


class DeviceIndex:
    """Device-resident index tables (replicated per device by default).
    Position lists are concatenated as [two-letter | three-letter C->T |
    three-letter G->A] so every candidate gather hits one array."""

    def __init__(self, index, device_put=None):
        jax, _ = _jm()
        put = device_put or jax.device_put
        g32 = pack_genome_u32(index.genome_words)
        self.genome32 = put(g32)
        self.genome2o = put(overlap_rows_u32(g32))
        self.counter2 = put(counter_pairs(index.counter))
        # three-letter counter tables stacked [c_to_t | g_to_a]
        self.counter3 = put(np.concatenate(
            [counter_pairs(index.counter_t),
             counter_pairs(index.counter_a)], axis=0))
        index_all = np.concatenate(
            [index.index, index.index_t, index.index_a]).astype(np.int32)
        if index_all.shape[0] == 0:
            index_all = np.zeros(1, np.int32)
        self.index_all = put(index_all)
        self.n_index2 = int(index.index.shape[0])
        self.n_index3 = int(index.index_t.shape[0])
        self.max_candidates = int(index.max_candidates)
        self.ext_iters = ext_iters_for(index)

    def tables(self):
        return (self.genome32, self.genome2o, self.counter2, self.counter3,
                self.index_all)


def ext_iters_for(index) -> int:
    """Static bisection depth for the pooled seed extension: enough
    iterations to converge a binary search over the LARGEST bucket of any
    of the three tables (derived on host from the counter prefix arrays;
    the extension only ever searches within one bucket)."""
    mb = 1
    for c in (index.counter, index.counter_t, index.counter_a):
        if c.shape[0] > 1:
            mb = max(mb, int(np.diff(c.astype(np.int64)).max()))
    return max(2, int(np.ceil(np.log2(mb + 1))) + 1)


def _tp_key_bounds(counter: np.ndarray, n_shards: int) -> np.ndarray:
    """Key-range boundaries (n_shards+1) splitting a bucket-offset prefix
    array into shards of ~equal position count; every bucket lands on
    exactly one shard."""
    total = int(counter[-1])
    targets = (np.arange(n_shards + 1, dtype=np.int64) * total) // n_shards
    bounds = np.searchsorted(counter, targets, side="left").astype(np.int64)
    bounds[0] = 0
    bounds[-1] = counter.shape[0] - 1
    return bounds


class DeviceIndexTP:
    """Key-range-sharded index tables (SURVEY 2.5 "TP option"): each shard
    owns a contiguous key range of each of the three tables -- boundaries
    chosen so position counts balance -- with the position lists sliced
    per shard and the genome + counter tables replicated.  Memory per device
    for the (dominant) position lists drops to ~1/n_shards, and rebased
    local offsets stay within i32 even when the global lists exceed 2^31
    entries."""

    def __init__(self, index, n_shards: int):
        self.n_shards = n_shards
        self.ext_iters = ext_iters_for(index)
        self.genome32 = pack_genome_u32(index.genome_words)
        self.counter2_np = counter_pairs(index.counter)
        self.counter3_np = np.concatenate(
            [counter_pairs(index.counter_t),
             counter_pairs(index.counter_a)], axis=0)
        b2 = _tp_key_bounds(index.counter, n_shards)
        bt = _tp_key_bounds(index.counter_t, n_shards)
        ba = _tp_key_bounds(index.counter_a, n_shards)
        c2, ct, ca = index.counter, index.counter_t, index.counter_a
        p2 = [int(c2[b2[s]]) for s in range(n_shards + 1)]
        pt = [int(ct[bt[s]]) for s in range(n_shards + 1)]
        pa = [int(ca[ba[s]]) for s in range(n_shards + 1)]
        self.P2 = max(1, max(p2[s + 1] - p2[s] for s in range(n_shards)))
        self.P3 = max(1, max(max(pt[s + 1] - pt[s], pa[s + 1] - pa[s])
                             for s in range(n_shards)))
        L = self.P2 + 2 * self.P3
        self.index_local = np.zeros((n_shards, L), dtype=np.int32)
        self.shardinfo = np.zeros((n_shards, 9), dtype=np.int32)
        for s in range(n_shards):
            i2 = index.index[p2[s] : p2[s + 1]]
            it = index.index_t[pt[s] : pt[s + 1]]
            ia = index.index_a[pa[s] : pa[s + 1]]
            self.index_local[s, : i2.shape[0]] = i2
            self.index_local[s, self.P2 : self.P2 + it.shape[0]] = it
            self.index_local[s, self.P2 + self.P3
                             : self.P2 + self.P3 + ia.shape[0]] = ia
            # position-list bases wrap modulo 2^32 (explicit astype, not a
            # Python-int assignment, which numpy>=2 would reject); the
            # device rebases with int32 wraparound subtraction, so local
            # offsets stay exact even when the GLOBAL lists exceed 2^31
            # entries (the counter tables wrap the same way above)
            self.shardinfo[s] = np.array(
                [b2[s], b2[s + 1], bt[s], bt[s + 1], ba[s], ba[s + 1],
                 p2[s], pt[s], pa[s]], dtype=np.int64).astype(np.int32)
        self.max_candidates = int(index.max_candidates)


def _resolve_cand_budget(cand_per_unit, n_index2, n_index3, lmax):
    if cand_per_unit is None:
        cand_per_unit = auto_cand_budget(n_index2, n_index3, lmax)
    return int(os.environ.get("ABISMAL_TPU_CAND_PER_UNIT", cand_per_unit))


CORE_CUTS = ("hash", "ranges", "extend", "list", "unitstats")


def popcount_compare(A, pk, ow, sh, nw):
    """Bisulfite popcount Hamming distance (full_compare,
    abismal.cpp:1105-1122) of each candidate's packed read words against
    its genome window: A (G, AW) u32 overlapped genome row, pk (G, NW) u32
    read words, ow (G,) i32 word offset of the window in the row (< 64),
    sh (G,) u32 nibble shift * 4, nw (G,) i32 valid words.  Returns
    d (G,) i32 = sum_j [j < nw] (8 - popcnt32(pk[j] & window_word[j])).
    Plain XLA, traced inside the caller's jit: the log-roll selects, the
    funnel shift, the popcount and the row reduction fuse into the
    consumer of the row gather."""
    jax, jnp = _jm()
    n_words = pk.shape[1]
    for s in (32, 16, 8, 4, 2, 1):
        rolled = jnp.concatenate(
            [A[:, s:], jnp.zeros((A.shape[0], s), A.dtype)], axis=1)
        A = jnp.where(((ow & s) != 0)[:, None], rolled, A)
    lo = A[:, :n_words]
    hi = A[:, 1 : n_words + 1]
    # window_word = (lo >> sh) | ((hi << (31 - sh)) << 1): the two-step
    # left shift realizes a 32-bit funnel shift that is well-defined when
    # sh == 0 (abismal.cpp:1110-1116 uses the same form on u64)
    shc = sh[:, None]
    w = (lo >> shc) | ((hi << (np.uint32(31) - shc)) << np.uint32(1))
    m = jax.lax.population_count(pk & w).astype(jnp.int32)
    widx = jnp.arange(n_words, dtype=jnp.int32)[None, :]
    return jnp.sum(jnp.where(widx < nw[:, None], 8 - m, 0), axis=1)


def _make_core(lmax: int, max_candidates: int, n_index2: int,
               n_index3: int, cand_per_unit: int, tp: bool,
               cut: str | None = None, ext_iters: int = 31,
               ext_pool: int | None = None):
    """Builds the candidate-generation core shared by stage-1 (event-stream
    output for the host replay) and the fused stage-1+2 program (device
    decide/align; build_stage12).

    Offset-parallel design, compaction before compare:
      1. rolling hash keys and bucket ranges for ALL (unit, offset, table)
         cells at once (no sequential scan over offsets);
      2. binary-search seed extension vectorized across every cell that
         needs it (rare; zero-iteration when no bucket exceeds
         max_candidates);
      3. per-cell candidate counts -> one global exclusive prefix sum ->
         a dense global candidate list (work proportional to the REAL
         number of candidates, not offsets x slots);
      4. one popcount-compare pass over the global list using contiguous
         window slice-gathers from the packed genome.

    The core packs ALL per-cell and per-unit values a candidate needs into
    ONE (B*n_cells, MEGA_W) row table gathered once per candidate
    ("megarow"), leaving exactly three per-candidate random accesses:
    the megarow, the position lookup (index_all) and the genome window row.

    Returns (core, o_spec): core(genome32, genome2o, counter2, counter3,
    index_all, pnib, lens, is_ga, uextra, shard) -> dict of per-candidate
    arrays (pos, d, b_of, cell_of, slot, valid, extras -- the per-unit
    uextra columns gathered per candidate), per-unit spans (unit_start,
    unit_total) and overflow flags (cell cap or unit candidate budget
    exceeded).  uextra: (B, E) i32 per-unit columns riding the megarow
    (E >= 1; callers put their per-unit thresholds here instead of paying
    their own per-candidate gathers)."""
    jax, jnp = _jm()
    ext_iters = int(os.environ.get("ABISMAL_TPU_EXT_ITERS", ext_iters))
    o_spec = o_spec_for(lmax)
    o_sens = lmax - KEY_WEIGHT + 1
    n_cells = (o_spec + o_sens) * 2
    n_words = 2 * ((lmax + 15) // 16)  # u32 words incl. the 0xF tail block
    CELLCAP = SLOT  # max candidates per cell
    CAND_PER_UNIT = cand_per_unit

    assert n_words + 1 + 63 <= 128, "lmax too long for one genome row"

    def nib_at(genome32, pos):
        word = genome32[(pos >> np.uint32(3)).astype(jnp.int32)]
        return (word >> ((pos & np.uint32(7)) * np.uint32(4))) & np.uint32(0xF)

    def core(genome32, genome2o, counter2, counter3, index_all, pnib, lens,
             is_ga, uextra, shard=None):
        """pnib: (B, (lmax+32)/2) u8 with two read nibbles per byte (base i
        in nibble i&1 of byte i>>1); lens: (B,) i32; is_ga: (B,) bool.
        Unpacking, word packing and word masks are all derived on device
        (abismal.cpp:1388-1426) -- the host uploads half a byte per base.

        In tp mode (key-range-sharded index; SURVEY 2.5 "TP option"),
        `index_all` is this shard's slice [idx2|idx3t|idx3a] padded to
        (n_index2 + 2*n_index3) and `shard` is i32[9]: key bounds
        [k2lo,k2hi,k3tlo,k3thi,k3alo,k3ahi] plus position-list bases
        [pb2,pb3t,pb3a]; cells whose key falls outside this shard's range
        are masked off (each bucket lives on exactly one shard, so the
        union of all shards' event streams, merged by rank, equals the
        unsharded stream).  Bucket SIZES come from the replicated counter
        tables, so specific/sensitive check policies are shard-invariant."""
        B = pnib.shape[0]
        # extension-pool size: active lanes are rare (~0.06/unit on the
        # GB-scale bench), so a quarter-of-B pool covers real workloads
        # with a wide margin while keeping the pool's window-LCP gather
        # pass (EXT_POOL x 258 rows) off the critical path; spills flag
        # units for exact host fallback
        EXT_POOL = int(os.environ.get(
            "ABISMAL_TPU_EXT_POOL",
            max(512, B // 4) if ext_pool is None else ext_pool))
        if tp:
            k2lo, k2hi = shard[0], shard[1]
            lo3u = jnp.where(is_ga, shard[4], shard[2])  # (B,) key bounds
            hi3u = jnp.where(is_ga, shard[5], shard[3])
            pb2 = shard[6]
            pb3u = jnp.where(is_ga, shard[8], shard[7])  # (B,) list base
        gflat = B * CAND_PER_UNIT
        preads = jnp.stack(
            [pnib & np.uint8(0xF), pnib >> np.uint8(4)], axis=2
        ).reshape(B, -1)
        ip = preads.astype(jnp.int32)

        # --- pack reads into u32 words, tail padded with 0xF match-any ---
        base = jnp.arange(n_words * 8, dtype=jnp.int32)[None, :]
        pad16 = ((lens + 15) // 16) * 16
        nibv = jnp.where(
            base < lens[:, None], preads[:, : n_words * 8].astype(jnp.uint32),
            jnp.where(base < pad16[:, None], np.uint32(0xF), np.uint32(0)))
        nibv = nibv.reshape(B, n_words, 8)
        packed = nibv[:, :, 0]
        for k in range(1, 8):
            packed = packed | (nibv[:, :, k] << np.uint32(4 * k))
        wmask = (jnp.arange(n_words, dtype=jnp.int32)[None, :]
                 < (2 * ((lens + 15) // 16))[:, None]).astype(jnp.int32)

        # --- rolling hashes for every offset (AbismalIndex.hpp:271-305),
        # log-doubling windows: H_{w+v}(i) = H_w(i)*r^v + H_v(i+w) turns
        # KEY_WEIGHT (25) + 2*KEY_WEIGHT_THREE (16) linear slice-combine
        # steps into ~5+4 (each step one shifted slice + mul/or) ---
        def windowed_full(sym, width, radix):
            """Sliding-window polynomial values of `sym` (base `radix`,
            msd-first): h[:, i] = sum_j sym[i+j] * radix^(width-1-j),
            via width doubling H_{w+v}(i) = H_w(i)*radix^v + H_v(i+w);
            full valid length (sym_len - width + 1)."""
            h = sym  # H_1
            w = 1
            while 2 * w <= width:
                h = (h[:, : h.shape[1] - w] * np.uint32(radix ** w)
                     + h[:, w:])
                w *= 2
            rem = width - w
            if rem:
                hr = windowed_full(sym, rem, radix)  # H_rem
                n = min(h.shape[1], hr.shape[1] - w)
                h = (h[:, :n] * np.uint32(radix ** rem)
                     + hr[:, w : w + n])
            return h

        def windowed(sym, width, radix):
            return windowed_full(sym, width, radix)[:, : o_sens]

        bits = ((ip & 5) == 0).astype(jnp.uint32)
        k2_all = windowed(bits, KEY_WEIGHT, 2)
        tct = ((((ip & 4) != 0) << 1) | ((ip & 1) != 0)).astype(jnp.uint32)
        tga = ((((ip & 8) != 0) << 1) | ((ip & 2) != 0)).astype(jnp.uint32)
        k3t = windowed(tct, KEY_WEIGHT_THREE, 3)
        k3a = windowed(tga, KEY_WEIGHT_THREE, 3)
        k3_all = jnp.where(is_ga[:, None], k3a % HASH3_MOD, k3t % HASH3_MOD)
        if cut == "hash":  # profiling cut: pack + rolling hashes
            return dict(cut=jnp.stack(
                [jnp.sum(packed.astype(jnp.int32)),
                 jnp.sum(k2_all.astype(jnp.int32)),
                 jnp.sum(k3_all.astype(jnp.int32)), jnp.sum(wmask)]))

        specific_len = jnp.minimum(lens - WINDOW_SIZE, lens >> 1)
        specific_lim = jnp.where(
            lens > 0, jnp.maximum(WINDOW_SIZE, lens >> 1), 0)
        sens_lim = lens - KEY_WEIGHT + 1
        base3 = n_index2 + is_ga.astype(jnp.int32) * n_index3  # into index_all
        c3_base = is_ga.astype(jnp.int32) * (counter3.shape[0] // 2)

        # --- bucket ranges for all cells, fully parallel: ONE pair-row
        # gather per table covers BOTH phases (the specific offsets are a
        # prefix of the sensitive ones, so spec ranges are a slice of the
        # same gather; 44-48 bp reads, whose specific limit exceeds the
        # sensitive one, are always device-fallback so the clipped slice
        # never reaches output) ---
        assert o_spec <= o_sens, "lmax too small for the shared gather"
        iof = jnp.arange(o_spec, dtype=jnp.int32)[None, :]
        act_sp = iof < specific_lim[:, None]
        jof = jnp.arange(o_sens, dtype=jnp.int32)[None, :]
        act_sn = (jof < sens_lim[:, None]) & (lens[:, None] > 0)
        if tp:
            k2r = k2_all[:, :o_spec].astype(jnp.int32)
            k3r = k3_all[:, :o_spec].astype(jnp.int32)
            act2_sp = act_sp & (k2r >= k2lo) & (k2r < k2hi)
            act3_sp = act_sp & (k3r >= lo3u[:, None]) & (k3r < hi3u[:, None])
        else:
            act2_sp = act3_sp = act_sp
        # gather mask: sizes must be GLOBAL on every shard (the sensitive
        # fold rule below compares across tables), so the gather is not
        # masked by shard ownership -- only the extracted values are
        gmask = act_sn | jnp.pad(act_sp, ((0, 0), (0, o_sens - o_spec)))
        k2n = jnp.where(gmask, k2_all, 0).astype(jnp.int32)
        p2 = counter2[k2n]  # (B, o_sens, 2) (start, end) pair rows
        k3n = (jnp.where(gmask, k3_all, 0).astype(jnp.int32)
               + c3_base[:, None])
        p3 = counter3[k3n]
        s2 = jnp.where(act2_sp, p2[:, :o_spec, 0], 0)
        e2 = jnp.where(act2_sp, p2[:, :o_spec, 1], 0)
        s3 = jnp.where(act3_sp, p3[:, :o_spec, 0], 0)
        e3 = jnp.where(act3_sp, p3[:, :o_spec, 1], 0)
        if tp:
            # rebase into this shard's local position lists (masked cells
            # collapse to the empty range [0, 0))
            s2 = jnp.where(act2_sp, s2 - pb2, 0)
            e2 = jnp.where(act2_sp, e2 - pb2, 0)
            s3 = jnp.where(act3_sp, s3 - pb3u[:, None], 0)
            e3 = jnp.where(act3_sp, e3 - pb3u[:, None], 0)

        if cut == "ranges":  # profiling cut: + specific bucket ranges
            return dict(cut=jnp.stack([jnp.sum(s2), jnp.sum(e2),
                                       jnp.sum(s3), jnp.sum(e3)]))

        # --- compacted-lane seed extension (LCP-window method) ---
        # The reference extends a seed one reduced-alphabet symbol at a
        # time, re-binary-searching the suffix-sorted bucket per symbol
        # until it holds <= max_candidates positions
        # (abismal.cpp:1152-1259).  A lockstep emulation of that loop over
        # all (B x o_spec x table) lanes wastes nearly all of its
        # gathers, because extension is only ACTIVE for a tiny fraction of
        # cells (bucket > max_candidates; ~0.05% measured).  Restructured:
        #   1. compact the active lanes of BOTH tables into EXT_POOL
        #      slots (pool overflow flags the unit for exact host
        #      fallback);
        #   2. one fused lower/upper-bound binary search per lane finds
        #      the bucket's full-depth match range [L, U) of the read's
        #      reduced-alphabet CLASS string -- sound because the bucket
        #      is lex-sorted by keys that refine class order to depth
        #      N_SORTING_POSITIONS (BucketLess/BucketLessThree,
        #      AbismalIndex.cpp:857-903);
        #   3. the per-symbol stopping state is recovered from the LCPs
        #      of the <= EXT_W window positions on each side of [L, U):
        #      the narrowing range at depth kw+t is exactly the
        #      contiguous run {q : lcp(q, read) >= t} around [L, U), so
        #      the stop depth t* (first t with count <= max_candidates)
        #      falls out of the 101st-largest window LCP, the reference's
        #      roll-back-to-previous-depth case is count(t*) == 0, and a
        #      final range wider than the window necessarily exceeds
        #      CELLCAP and triggers the unit-overflow fallback anyway, so
        #      window clipping never changes output.
        # Reads longer than N_SORTING_POSITIONS could search beyond the
        # sort depth (where step-wise narrowing and direct search can
        # disagree); such active lanes flag the unit for host fallback.
        stride = preads.shape[1]
        EXT_W = SLOT + 1  # window half-width: CELLCAP + 1
        DQMAX = lmax - KEY_WEIGHT_THREE  # deepest possible compare
        QW = (DQMAX + 7) // 8  # u32 class words, 8 nibbles each
        BIGI = np.int32(0x3FFFFFFF)
        n_lanes = B * o_spec
        act_ext2 = act2_sp & ((e2 - s2) > max_candidates)
        act_ext3 = act3_sp & ((e3 - s3) > max_candidates)
        flat_act = jnp.concatenate(
            [act_ext2.reshape(-1), act_ext3.reshape(-1)])
        (lane_id,) = jnp.nonzero(flat_act, size=EXT_POOL,
                                 fill_value=2 * n_lanes)
        # lanes beyond the pool: flag their units for host fallback
        # (reshape+any, not a scatter: lane order is (table, unit, offset))
        cum_act = jnp.cumsum(flat_act.astype(jnp.int32))
        over_lane = flat_act & (cum_act > EXT_POOL)
        ext_fb = jnp.any(over_lane.reshape(2, B, o_spec), axis=(0, 2))

        pvv = lane_id < 2 * n_lanes
        lid = jnp.minimum(lane_id, 2 * n_lanes - 1)
        tbl3 = lid >= n_lanes
        rem = lid % n_lanes
        pb = rem // o_spec
        poff = rem % o_spec
        kw_l = jnp.where(tbl3, KEY_WEIGHT_THREE, KEY_WEIGHT)
        p_ga = is_ga[pb] & tbl3  # alphabet: 2-letter lanes ignore is_ga
        idx_b = jnp.where(tbl3, base3[pb], 0)
        lo0 = jnp.where(tbl3, s3.reshape(-1)[rem], s2.reshape(-1)[rem])
        hi0 = jnp.where(tbl3, e3.reshape(-1)[rem], e2.reshape(-1)[rem])
        rl = lens[pb] - poff  # read_lim (abismal.cpp:1163-1259)
        Dl = jnp.clip(rl - kw_l, 0, DQMAX)
        ext_fb = ext_fb | jnp.zeros(B, bool).at[
            jnp.where(pvv, pb, 0)].max(pvv & (rl > N_SORTING_POSITIONS))

        # query class words, aligned to read offset poff + kw
        qoff = poff + kw_l
        qa = ip[pb]  # (P, stride) row gather
        s_roll = 1
        while s_roll * 2 <= o_spec + KEY_WEIGHT:
            s_roll *= 2
        while s_roll >= 1:
            rolled = jnp.concatenate(
                [qa[:, s_roll:],
                 jnp.zeros((EXT_POOL, s_roll), qa.dtype)], axis=1)
            qa = jnp.where((qoff & s_roll)[:, None] != 0, rolled, qa)
            s_roll //= 2

        def nib_cls(nib, t3, ga):
            b0 = nib & 1
            b1 = (nib >> 1) & 1
            b2 = (nib >> 2) & 1
            b3 = (nib >> 3) & 1
            hi3 = jnp.where(ga, b3, b2)
            lo3 = jnp.where(ga, b1, b0) | hi3
            c3v = 2 * hi3 + (lo3 & (1 - hi3))
            c2v = 1 - (b0 | b2)
            return jnp.where(t3, c3v, c2v)

        qcn = nib_cls(qa[:, : 8 * QW], tbl3[:, None],
                      p_ga[:, None]).astype(jnp.uint32)
        qcn = qcn.reshape(EXT_POOL, QW, 8)
        qcls = qcn[:, :, 0]
        for k in range(1, 8):
            qcls = qcls | (qcn[:, :, k] << np.uint32(4 * k))

        wj8 = 8 * jnp.arange(QW, dtype=jnp.int32)

        def gwin_cls(g0, t3, ga):
            """Genome class words for flat nibble positions g0 (u32):
            one overlapped-row gather + word/nibble alignment + packed
            per-nibble class transform."""
            w0 = g0 >> np.uint32(3)
            row = (w0 >> np.uint32(6)).astype(jnp.int32)
            A = genome2o[row]  # 128-word rows: 63 + QW+1 <= 128 always
            # the alignment roll only ever reads words [ow, ow + QW + 1)
            # with ow < 64: clip the row before rolling (the roll's
            # masked-shift passes are elementwise cost, ~40% of the
            # extension loop body at lmax = 128)
            A = A[:, : min(128, 64 + QW + 1)]
            ow = (w0 & np.uint32(63)).astype(jnp.int32)
            for s_ in (32, 16, 8, 4, 2, 1):
                rolled = jnp.concatenate(
                    [A[:, s_:], jnp.zeros((A.shape[0], s_), jnp.uint32)],
                    axis=1)
                A = jnp.where((ow & s_)[:, None] != 0, rolled, A)
            sh = (g0 & np.uint32(7)) * np.uint32(4)
            wal = (A[:, :QW] >> sh[:, None]) | (
                (A[:, 1 : QW + 1] << (np.uint32(31) - sh)[:, None])
                << np.uint32(1))
            m1 = np.uint32(0x11111111)
            b0 = wal & m1
            b1 = (wal >> np.uint32(1)) & m1
            b2 = (wal >> np.uint32(2)) & m1
            b3 = (wal >> np.uint32(3)) & m1
            hi3 = jnp.where(ga[:, None], b3, b2)
            lo3 = jnp.where(ga[:, None], b1, b0) | hi3
            cls3 = (hi3 << np.uint32(1)) | (lo3 & ~hi3)
            cls2 = (b0 | b2) ^ m1
            return jnp.where(t3[:, None], cls3, cls2)

        def lex(gcls, qclsN, DlN):
            """(lcp, cmp) of genome vs query class strings, depth DlN."""
            nrem = jnp.clip(DlN[:, None] - wj8[None, :], 0, 8)
            shv = (4 * jnp.where(nrem >= 8, 0, nrem)).astype(jnp.uint32)
            dmask = jnp.where(nrem >= 8, np.uint32(0xFFFFFFFF),
                              (np.uint32(1) << shv) - np.uint32(1))
            diff = (gcls ^ qclsN) & dmask
            nz = diff != np.uint32(0)
            ctz = jax.lax.population_count((~diff)
                                           & (diff - np.uint32(1)))
            candn = jnp.where(
                nz, wj8[None, :] + (ctz >> np.uint32(2)).astype(jnp.int32),
                BIGI)
            mis = jnp.min(candn, axis=1)
            lcp = jnp.minimum(mis, DlN)
            wjx = jnp.clip(mis >> 3, 0, QW - 1)[:, None]
            shx = ((mis & 7) * 4).astype(jnp.uint32)
            gv = (jnp.take_along_axis(gcls, wjx, axis=1)[:, 0] >> shx
                  ) & np.uint32(0xF)
            qv = (jnp.take_along_axis(qclsN, wjx, axis=1)[:, 0] >> shx
                  ) & np.uint32(0xF)
            cmp = jnp.where(mis < DlN,
                            jnp.where(gv < qv, -1, 1), 0)
            return lcp, cmp

        if os.environ.get("ABISMAL_TPU_NOEXT"):
            # profiling-only variant: skip the extension entirely
            # (changes semantics; never used by the product path)
            l2 = jnp.full((B, o_spec), KEY_WEIGHT, jnp.int32)
            s2x, e2x = s2, e2
            l3 = jnp.full((B, o_spec), KEY_WEIGHT_THREE, jnp.int32)
            s3x, e3x = s3, e3
            ext_fb = jnp.zeros(B, bool)
        else:
            # fused lower/upper-bound search over the class-sorted bucket;
            # fori_loop (not an unrolled Python loop) keeps the compiled
            # HLO a single body -- at GB scale ext_iters is ~20+ and the
            # unrolled form dominated compile time.  The search is K-ARY
            # (WAYS-1 probes per bound per iteration): each iteration of
            # the loop is serial latency (a dependent index_all gather +
            # the gwin_cls alignment rolls), so WAYS trades probe lanes
            # for loop trips.  WAYS = 4 was fitted on a different device
            # and is not measured on the GPU (ROADMAP A3).
            WAYS = int(os.environ.get("ABISMAL_TPU_EXT_WAYS", 4))
            NPRB = WAYS - 1
            tbl2x = jnp.tile(tbl3, 2 * NPRB)
            ga2x = jnp.tile(p_ga, 2 * NPRB)
            D2x = jnp.tile(Dl, 2 * NPRB)
            ib2x = jnp.tile(idx_b, 2 * NPRB)
            kw2x = jnp.tile(kw_l, 2 * NPRB).astype(jnp.uint32)
            qcls2x = jnp.tile(qcls, (2 * NPRB, 1))
            kf = jnp.arange(1, WAYS, dtype=jnp.int32)[:, None]  # (NPRB, 1)

            def bis_body(_, st):
                aL, bL, aU, bU = st
                # interior probes ~ a + floor(w*k/WAYS), k = 1..WAYS-1,
                # computed as k*(w//W) + k*(w%W)//W so k*w cannot overflow
                # i32 (GB-scale low-complexity buckets reach 2^30 slots);
                # duplicates when w < WAYS are harmless: updates are
                # monotone max/min and guarded by a<b
                wL, wU = bL - aL, bU - aU
                pL = (aL[None, :] + kf * (wL[None, :] // WAYS)
                      + (kf * (wL[None, :] % WAYS)) // WAYS)
                pU = (aU[None, :] + kf * (wU[None, :] // WAYS)
                      + (kf * (wU[None, :] % WAYS)) // WAYS)
                mids = jnp.concatenate(
                    [pL.reshape(-1), pU.reshape(-1)])
                gpos = (index_all[ib2x + mids].astype(jnp.uint32) + kw2x)
                _, cmp = lex(gwin_cls(gpos, tbl2x, ga2x), qcls2x, D2x)
                half = NPRB * EXT_POOL
                cmpL = cmp[:half].reshape(NPRB, EXT_POOL)
                cmpU = cmp[half:].reshape(NPRB, EXT_POOL)
                cL, cU = aL < bL, aU < bU
                gL, gU = cmpL < 0, cmpU <= 0
                aL = jnp.max(jnp.where(cL[None, :] & gL, pL + 1,
                                       aL[None, :]), axis=0)
                bL = jnp.min(jnp.where(cL[None, :] & ~gL, pL,
                                       bL[None, :]), axis=0)
                aU = jnp.max(jnp.where(cU[None, :] & gU, pU + 1,
                                       aU[None, :]), axis=0)
                bU = jnp.min(jnp.where(cU[None, :] & ~gU, pU,
                                       bU[None, :]), axis=0)
                return aL, bL, aU, bU

            # iteration count: the interval shrinks by ~WAYS each trip
            # (binary ext_iters covers 2^ext_iters, so ceil to the k-ary
            # log plus one slack trip for the floor-probe rounding)
            kbits = max(1, int(np.log2(WAYS)))
            kary_iters = -(-ext_iters // kbits) + 1
            if os.environ.get("ABISMAL_TPU_EXT_UNROLL"):
                st = (lo0, hi0, lo0, hi0)
                for _i in range(kary_iters):
                    st = bis_body(_i, st)
                Lb, _, Ub, _ = st
            else:
                Lb, _, Ub, _ = jax.lax.fori_loop(
                    0, kary_iters, bis_body, (lo0, hi0, lo0, hi0))

            # LCP window: EXT_W positions on each side of [L, U)
            wi = jnp.arange(EXT_W, dtype=jnp.int32)
            wofs = jnp.concatenate(
                [Lb[:, None] - 1 - wi[None, :], Ub[:, None] + wi[None, :]],
                axis=1)  # (P, 2W)
            wvalid = ((wofs >= lo0[:, None]) & (wofs < hi0[:, None])
                      & pvv[:, None])
            wc = jnp.clip(wofs, lo0[:, None],
                          jnp.maximum(lo0, hi0 - 1)[:, None])
            n_w = 2 * EXT_W
            wposf = (index_all[(idx_b[:, None] + wc).reshape(-1)]
                     .astype(jnp.uint32)
                     + jnp.repeat(kw_l.astype(jnp.uint32), n_w))
            gcls_w = gwin_cls(wposf, jnp.repeat(tbl3, n_w),
                              jnp.repeat(p_ga, n_w))
            qcls_w = jnp.broadcast_to(
                qcls[:, None, :], (EXT_POOL, n_w, QW)).reshape(-1, QW)
            lcp_w, _ = lex(gcls_w, qcls_w, jnp.repeat(Dl, n_w))
            lcp_w = jnp.where(wvalid.reshape(-1), lcp_w,
                              -1).reshape(EXT_POOL, n_w)

            # stop depth t*, rollback, and final range from window LCPs
            c0 = Ub - Lb
            topv, _ = jax.lax.top_k(lcp_w, max_candidates + 1)
            kidx = jnp.clip(max_candidates - c0, 0, max_candidates)[:, None]
            kth = jnp.take_along_axis(topv, kidx, axis=1)[:, 0]
            tstar = jnp.where(c0 > max_candidates, BIGI,
                              jnp.maximum(1, kth + 1))
            tfin = jnp.minimum(tstar, Dl)
            cnt_fin = c0 + jnp.sum((lcp_w >= tfin[:, None])
                                   .astype(jnp.int32), axis=1)
            rollb = (cnt_fin == 0) & (tfin >= 1)
            t_use = jnp.where(rollb, tfin - 1, tfin)
            l_out = kw_l + t_use
            thr_t = jnp.maximum(t_use, 1)[:, None]
            nl = jnp.sum((lcp_w[:, :EXT_W] >= thr_t).astype(jnp.int32),
                         axis=1)
            nr = jnp.sum((lcp_w[:, EXT_W:] >= thr_t).astype(jnp.int32),
                         axis=1)
            fullr = t_use == 0
            lo_f = jnp.where(fullr, lo0, Lb - nl)
            hi_f = jnp.where(fullr, hi0, Ub + nr)

            # scatter pooled results back into the per-cell arrays
            d_t2 = jnp.where(pvv & ~tbl3, rem, n_lanes)
            d_t3 = jnp.where(pvv & tbl3, rem, n_lanes)
            pad1 = jnp.zeros(1, jnp.int32)
            l2 = jnp.concatenate(
                [jnp.full(n_lanes, KEY_WEIGHT, jnp.int32), pad1]
            ).at[d_t2].set(l_out)[:n_lanes].reshape(B, o_spec)
            s2x = jnp.concatenate([s2.reshape(-1), pad1]).at[d_t2].set(
                lo_f)[:n_lanes].reshape(B, o_spec)
            e2x = jnp.concatenate([e2.reshape(-1), pad1]).at[d_t2].set(
                hi_f)[:n_lanes].reshape(B, o_spec)
            l3 = jnp.concatenate(
                [jnp.full(n_lanes, KEY_WEIGHT_THREE, jnp.int32), pad1]
            ).at[d_t3].set(l_out)[:n_lanes].reshape(B, o_spec)
            s3x = jnp.concatenate([s3.reshape(-1), pad1]).at[d_t3].set(
                lo_f)[:n_lanes].reshape(B, o_spec)
            e3x = jnp.concatenate([e3.reshape(-1), pad1]).at[d_t3].set(
                hi_f)[:n_lanes].reshape(B, o_spec)

        if cut == "extend":  # profiling cut: + binary-search extension
            return dict(cut=jnp.stack([jnp.sum(l2), jnp.sum(s2x),
                                       jnp.sum(l3), jnp.sum(e3x)]))
        if cut == "extdbg":  # debug cut: full per-cell extension outputs
            return dict(l2=l2, s2x=s2x, e2x=e2x, l3=l3, s3x=s3x, e3x=e3x,
                        ext_fb=ext_fb, s2=s2, e2=e2, s3=s3, e3=e3)

        d2 = e2x - s2x
        d3 = e3x - s3x
        check2_sp = act2_sp & ((d2 <= max_candidates)
                               | (l2 >= specific_len[:, None]))
        check3_sp = act3_sp & ((d3 <= max_candidates)
                               | (l3 >= specific_len[:, None]))

        # --- sensitive-phase cells (no extension): ranges come from the
        # shared pair-row gather above (p2/p3).  Bucket SIZES are masked
        # by act_sn only (they must be the GLOBAL sizes on every shard:
        # the 2-vs-3-letter fold rule below compares across tables, and
        # in tp mode a shard can own the 2-letter bucket without owning
        # the 3-letter one); list OFFSETS are additionally masked by
        # shard ownership and rebased ---
        if tp:
            k2rn = k2_all.astype(jnp.int32)
            k3rn = k3_all.astype(jnp.int32)
            act2_sn = act_sn & (k2rn >= k2lo) & (k2rn < k2hi)
            act3_sn = act_sn & (k3rn >= lo3u[:, None]) & (
                k3rn < hi3u[:, None])
        else:
            act2_sn = act3_sn = act_sn
        s2n_g = jnp.where(act_sn, p2[..., 0], 0)
        e2n_g = jnp.where(act_sn, p2[..., 1], 0)
        d2n = e2n_g - s2n_g
        s3n_g = jnp.where(act_sn, p3[..., 0], 0)
        e3n_g = jnp.where(act_sn, p3[..., 1], 0)
        d3n = e3n_g - s3n_g
        if tp:
            s2n = jnp.where(act2_sn, s2n_g - pb2, 0)
            s3n = jnp.where(act3_sn, s3n_g - pb3u[:, None], 0)
        else:
            s2n, s3n = s2n_g, s3n_g
        check2_sn = act2_sn & (d2n != 0) & (d2n <= max_candidates) & (
            (d3n == 0) | (d2n <= MIN_FOLD_SIZE * d3n))
        check3_sn = act3_sn & (d3n != 0) & (d3n <= max_candidates)

        # --- per-cell counts and global start offsets, rank order ---
        def interleave(a, b):
            return jnp.stack([a, b], axis=2).reshape(B, -1)

        cnt_sp = interleave(jnp.where(check2_sp, d2, 0),
                            jnp.where(check3_sp, d3, 0))
        cnt_sn = interleave(jnp.where(check2_sn, d2n, 0),
                            jnp.where(check3_sn, d3n, 0))
        cnt_cells = jnp.concatenate([cnt_sp, cnt_sn], axis=1)
        overflow = jnp.any(cnt_cells > CELLCAP, axis=1) | ext_fb
        cnt_cells = jnp.minimum(cnt_cells, CELLCAP)

        lo_sp = interleave(s2x, base3[:, None] + s3x)
        lo_sn = interleave(s2n, base3[:, None] + s3n)
        lo_cells = jnp.concatenate([lo_sp, lo_sn], axis=1)

        # --- global candidate list via prefix sums ---
        cnt_flat = cnt_cells.reshape(-1)
        inc = jnp.cumsum(cnt_flat)
        total = inc[-1]
        unit_total = jnp.sum(cnt_cells, axis=1)
        unit_start = jnp.cumsum(unit_total) - unit_total
        overflow = overflow | (unit_start + unit_total > gflat)

        # candidate -> cell mapping via scatter + running max instead of
        # a binary search per candidate.  EVERY cell marks at its
        # (clamped) exclusive prefix -- so the indices are sorted, and the
        # scatter says so -- and the max over a run of equal starts is the
        # run's single nonzero cell (a nonzero
        # cell always terminates its equal-start run, and trailing
        # all-zero cells mark at `total`, past every valid candidate)
        f = jnp.arange(gflat, dtype=jnp.int32)
        starts = inc - cnt_flat  # exclusive prefix, (B*n_cells,)
        gid_vals = jnp.arange(B * n_cells, dtype=jnp.int32)
        cellmark = jnp.zeros(gflat + 1, dtype=jnp.int32).at[
            jnp.minimum(starts, gflat)].max(
            gid_vals, indices_are_sorted=True)
        cell_gid = jax.lax.associative_scan(jnp.maximum, cellmark[:gflat])
        b_of = cell_gid // n_cells
        cell_of = cell_gid % n_cells
        valid = f < total

        # --- megarow: ONE row gather carries every per-cell and per-unit
        # value a candidate needs (see the cost model in the builder
        # docstring): [cell start, bucket offset, packed read words,
        # valid-word count, caller extras]
        nw_unit = 2 * ((lens + 15) // 16)  # valid words per unit
        ucols = jnp.concatenate(
            [jax.lax.bitcast_convert_type(packed, jnp.int32),
             nw_unit[:, None], uextra.astype(jnp.int32)], axis=1)
        E = ucols.shape[1]
        tbl = jnp.concatenate(
            [jnp.stack([starts.reshape(B, n_cells),
                        lo_cells], axis=2),
             jnp.broadcast_to(ucols[:, None, :], (B, n_cells, E))],
            axis=2).reshape(B * n_cells, 2 + E)
        mega = tbl[cell_gid]
        slot = f - mega[:, 0]
        lo_flat = mega[:, 1]
        packed_rows = jax.lax.bitcast_convert_type(
            mega[:, 2 : 2 + n_words], jnp.uint32)
        nw_of = mega[:, 2 + n_words]
        extras = mega[:, 3 + n_words :]

        # per-cell seed offset, by rank arithmetic (no table lookup)
        coff = jnp.where(cell_of < 2 * o_spec, cell_of >> 1,
                         (cell_of - 2 * o_spec) >> 1)
        pos = (index_all[jnp.where(valid, lo_flat + slot, 0)]
               .astype(jnp.uint32) - coff.astype(jnp.uint32))
        pos = jnp.where(valid, pos, 0)

        if cut == "list":  # profiling cut: + global candidate list (pos)
            return dict(cut=jnp.stack([jnp.sum(pos.astype(jnp.int32)),
                                       jnp.sum(b_of), jnp.sum(slot),
                                       jnp.sum(unit_total)]))
        if cut == "unitstats":  # diagnostics: per-unit candidate counts +
            # overflow flags (candidate-budget measurement)
            return dict(cut=jnp.stack([unit_total,
                                       overflow.astype(jnp.int32)]))

        # --- popcount compare over contiguous genome windows ---
        # ONE overlapped aligned-row gather per candidate (64 words cover
        # any 19-word window), then the word-alignment log-roll, nibble
        # shift and popcount reduction on the gathered rows
        w = (pos >> np.uint32(3)).astype(jnp.int32)
        sh = (pos & np.uint32(7)) * np.uint32(4)
        A = genome2o[w >> 6]  # 128-word rows: 63 + 65 words <= 128 always
        ow = w & 63
        d = popcount_compare(A, packed_rows, ow, sh, nw_of)

        return dict(pos=pos, d=d, b_of=b_of, cell_of=cell_of, slot=slot,
                    valid=valid, extras=extras, unit_start=unit_start,
                    unit_total=unit_total, overflow=overflow)

    return core, o_spec


def build_stage1(lmax: int, max_candidates: int, n_index2: int,
                 n_index3: int, cand_per_unit: int | None = None,
                 gcap_per_unit: int | None = None, tp: bool = False,
                 ext_iters: int = 31):
    """Builds the jitted stage-1 function for a given padded read length:
    the candidate core (_make_core) plus compaction of accepted events
    (diffs <= 0.4*len, the largest cutoff the sequential engine can ever
    apply) into a dense global stream for the host replay.

    Memoized per parameter tuple so engines share one compilation."""
    # global candidate budget per unit, pooled across the batch; units
    # beyond it fall back to the exact host path.  Defaults scale with the
    # index's bucket density (auto_cand_budget); env knobs override.
    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    if gcap_per_unit is None:
        gcap_per_unit = 32
    gcap_per_unit = int(os.environ.get("ABISMAL_TPU_GCAP_PER_UNIT",
                                       gcap_per_unit))
    memo_key = (lmax, max_candidates, n_index2, n_index3, cand_per_unit,
                gcap_per_unit, tp, ext_iters)
    if memo_key in _stage1_memo:
        return _stage1_memo[memo_key]
    jax, jnp = _jm()
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, tp, ext_iters=ext_iters)
    GCAP_PER_UNIT = gcap_per_unit
    CAND_PER_UNIT = cand_per_unit

    def stage1(genome32, genome2o, counter2, counter3, index_all, pnib,
               lens, is_ga, thr, shard=None):
        """Returns (ev, cf): a global event stream (u32 positions and
        (diffs+512)<<22|rank) and per-unit count|overflow words (the
        device->host link prefers few small messages)."""
        B = pnib.shape[0]
        gcap = B * GCAP_PER_UNIT
        gflat = B * CAND_PER_UNIT
        c = core(genome32, genome2o, counter2, counter3, index_all,
                 pnib, lens, is_ga, thr[:, None], shard)
        pos, d = c["pos"], c["d"]
        cell_of, slot, valid = c["cell_of"], c["slot"], c["valid"]
        unit_start, unit_total = c["unit_start"], c["unit_total"]
        overflow = c["overflow"]

        # thr rides the megarow (core extras): no per-candidate gather
        accept = valid & (d <= c["extras"][:, 0])

        # --- compact accepted events into the global stream ---
        acc = accept.astype(jnp.int32)
        gdest = jnp.cumsum(acc) - acc
        ok = accept & (gdest < gcap)
        gdest_c = jnp.where(ok, gdest, gcap)
        rank = cell_of * SLOT + slot
        # diffs biased by +512 into a 10-bit field (IUPAC genome codes can
        # drive the popcount distance down to -len, so lmax up to 512 stays
        # in range); rank uses the low 22 bits (enough for lmax 512:
        # 1488 cells x 128 slots)
        meta = (((d + 512).astype(jnp.uint32)) << 22) | rank.astype(
            jnp.uint32)
        # ONE row scatter for (pos, meta)
        gev = jnp.zeros((gcap + 1, 2), dtype=jnp.uint32).at[gdest_c].set(
            jnp.stack([pos, jnp.where(ok, meta, 0)], axis=1))
        # per-unit accepted-event counts from the accept prefix sums
        acc_inc = gdest + acc  # inclusive cumsum of acc
        acc_at = jnp.concatenate([jnp.zeros(1, jnp.int32), acc_inc])
        ustart = jnp.minimum(unit_start, gflat)
        uend = jnp.minimum(unit_start + unit_total, gflat)
        count = acc_at[uend] - acc_at[ustart]
        # a unit dropped events iff its accepted span crosses the gcap
        # boundary (arithmetic on the prefix sums, not a scatter)
        dropped = acc_at[uend] > jnp.maximum(gcap, acc_at[ustart])
        overflow = overflow | dropped

        # short reads (< DEVICE_MIN_LEN bp) can drive the reference
        # extension past the read end (UB upstream); route them to the host
        # path, as well as reads whose length or 0.4*len threshold exceeds
        # the 10-bit biased diffs field of the packed event meta (len > 512)
        overflow = (overflow | ((lens > 0) & (lens < DEVICE_MIN_LEN))
                    | (thr > 511) | (lens > 512))
        ev = gev[:gcap].T
        cf = count | (overflow.astype(jnp.int32) << 30)
        return ev, cf

    result = (jax.jit(stage1), o_spec)
    _stage1_memo[memo_key] = result
    return result


_stage12_memo = {}

# stage-2 record status codes (shared with native engine_se_finalize)
REC_UNMAPPED, REC_EXACT, REC_ALIGNED, REC_FALLBACK = 0, 1, 2, 3

# device-traceback cigar buffer: run-length ops per winner.  Real cigars
# hold <= 2*max_diffs+1 non-clip runs (every I/D run costs >= 4 score, so
# a 100 bp read at max_diffs 10 has <= 21); overflowing reads take the
# host traceback for that read alone (n_ops = -1), so the cap trades
# device payload for fallback rate, never correctness.
TB_NOPS = 24


def build_tb_block(lmax: int, interpret: bool = False):
    """Device traceback for winner alignments (build_traceback,
    AbismalAlign.hpp:388-440 / the native build_traceback): the tracer
    kernel re-runs the banded DP storing packed (arrow, positive) nibbles
    -- 8 band rows per i32 word -- plus the row-major-first argmax cell,
    then a lane-parallel while_loop walks the arrows emitting run-length
    cigar ops in walk order.

    Returns tb(q2 (J2, lmax) u8, win2 (J2, lmax+QOFF) u8, wbw (J2,) i32,
    wqsz (J2,) i32, wpos (J2,) u32, do_tb (J2,) bool) ->
      ops  (J2, TB_NOPS) i32: (run_len << 4 | op) in WALK order (the
           caller reverses and adds the soft clips)
      meta (J2, 4) i32: [n_ops (-1 = not traced / buffer overflow),
           soft_bottom, soft_top, new_pos (u32 bitcast)]
    Untraced lanes must carry bw = 1, qsz = 0."""
    from ..kernels.banded_align import BAND as TB_BAND
    from ..kernels.banded_align import QOFF, build_banded_tracer

    jax, jnp = _jm()
    tracer = build_banded_tracer(lmax, interpret=interpret)
    WW3 = lmax + QOFF
    NWP = (WW3 + 7) // 8
    NOPS = TB_NOPS
    MAXSTEP = WW3 + 2 * (QOFF + 1) + 4

    def tb(q2, win2, wbw, wqsz, wpos, do_tb):
        J2 = q2.shape[0]
        panel, tbest, brr, bc = tracer(q2, win2, wbw[:, None],
                                       wqsz[:, None])
        panelf = panel.reshape(-1)
        jid2 = jnp.arange(J2, dtype=jnp.int32)

        def fetch(i, j):
            rr = i - wbw + QOFF
            idx = ((rr >> 3) * TB_BAND + j) * J2 + jid2
            ok = (rr >= 0) & (rr < NWP * 8) & (j >= 0) & (j < TB_BAND)
            word = panelf[jnp.clip(idx, 0, panelf.shape[0] - 1)]
            return jnp.where(ok, (word >> ((rr & 7) * 4)) & 0xF, 0)

        # initial step from the argmax cell (arrow read unconditionally;
        # table[best] > 0 is guaranteed for traced lanes)
        i0 = brr - QOFF + wbw
        j0 = bc
        started = do_tb & (tbest > 0)
        a0 = fetch(i0, j0) & 3
        isI0 = a0 == 1
        isD0 = a0 == 2
        i1 = i0 - jnp.where(isI0, 0, 1)
        j1 = j0 - isI0.astype(jnp.int32) + isD0.astype(jnp.int32)
        opsb0 = jnp.zeros((J2, NOPS), jnp.int32)
        kops = jnp.arange(NOPS, dtype=jnp.int32)[None, :]

        def w_cond(st):
            return jnp.any(st[0]) & (st[8] < MAXSTEP)

        def w_body4(st):
            # 4 walk steps per loop trip (the walk runs ~readlen serial
            # steps and every trip has a fixed cost; the unroll is not
            # measured on the GPU); inner steps are act-masked no-ops when
            # a lane (or the whole panel) has already finished
            for _ in range(4):
                st = w_body(st)
            return st

        def w_body(st):
            act, i, j, prv, n, cnt, ops, over, stp = st
            nibw = fetch(i, j)
            act = act & ((nibw & 4) != 0)
            arrow = nibw & 3
            emit = act & (arrow != prv)
            val = (n << 4) | prv
            ops = jnp.where(emit[:, None]
                            & (kops == jnp.minimum(cnt, NOPS - 1)[:, None]),
                            val[:, None], ops)
            over = over | (emit & (cnt >= NOPS))
            cnt = cnt + emit.astype(jnp.int32)
            n = jnp.where(emit, 1, n + act.astype(jnp.int32))
            isI = act & (arrow == 1)
            isD = act & (arrow == 2)
            i = jnp.where(act & ~isI, i - 1, i)
            j = j - isI.astype(jnp.int32) + isD.astype(jnp.int32)
            prv = jnp.where(act, arrow, prv)
            return act, i, j, prv, n, cnt, ops, over, stp + 1

        st0 = (started, i1, j1, a0, jnp.ones(J2, jnp.int32),
               jnp.zeros(J2, jnp.int32), opsb0, jnp.zeros(J2, bool),
               jnp.zeros((), jnp.int32))
        actF, iF, jF, prvF, nF, cntF, opsF, overF, _ = \
            jax.lax.while_loop(w_cond, w_body4, st0)
        # final run emit (the walk's trailing (n, prev_arrow))
        valF = (nF << 4) | prvF
        opsF = jnp.where(started[:, None]
                         & (kops == jnp.minimum(cntF, NOPS - 1)[:, None]),
                         valF[:, None], opsF)
        overF = overF | (started & (cntF >= NOPS)) | actF
        cntF = cntF + started.astype(jnp.int32)
        soft_bottom = (wqsz + wbw - 1) - (i0 + j0)
        soft_top = (iF + jF) - (wbw - 1)
        newpos = (wpos - ((wbw - 1) // 2).astype(jnp.uint32)
                  + iF.astype(jnp.uint32))
        n_ops = jnp.where(started & ~overF, cntF, -1)
        meta = jnp.stack(
            [n_ops, soft_bottom, soft_top,
             jax.lax.bitcast_convert_type(newpos, jnp.int32)], axis=1)
        return opsF, meta

    return tb


def build_stage12(lmax: int, max_candidates: int, n_index2: int,
                  n_index3: int, per: int, cand_per_unit: int | None = None,
                  k_slots: int = 50, jobs_per_read: int = 8,
                  interpret: bool = False, cut: str | None = None,
                  ext_iters: int = 31, device_tb: bool | None = None,
                  ext_pool: int | None = None):
    """Fused device stage-1+2 for single-end mapping: ONE jitted program
    runs candidate generation (the shared core), the reference's candidate
    -set decision logic, batched banded-alignment scoring, and
    winner selection -- returning a 16-byte record per READ instead of a
    per-candidate event stream (SURVEY 7 Phase 2; the round-2 verdict's
    top ask).  The host keeps only traceback-for-winners and SAM text.

    Exactness argument (vs abismal.cpp:1269-1497): while the 50-slot
    max-heap never fills, its adaptive cutoff is constant per phase --
    the heap root stays the reset sentinel (diffs = 0.4*len), so
    `cutoff` is good_cutoff (= len/10) for the whole specific phase and
    0.4*len for the whole sensitive phase, `should_do_sensitive()` is
    always true, and eviction never happens.  The surviving candidate
    set is then exactly the set of gate-passing events (order-free), and
    the exact-match/ambiguity tracking reduces to first/any reductions.
    sure_ambig early-exits only skip events when an ambiguous exact match
    exists, in which case the candidate heap is never consulted
    (align_se_candidates returns the exact best immediately), so the
    skipped inserts cannot affect output.  Reads with >= 49 non-exact
    accepted events (the heap WOULD fill, unless the sure-ambig
    refinement below decides them), reads whose gated events overrun the
    K2 slot window without proving exact ambiguity, overflowed units,
    short reads (< 49 bp) or more alignment jobs than the batch job
    budget are flagged REC_FALLBACK and re-mapped exactly on the host --
    output is byte-identical to the reference at any fallback rate.

    per: units per read (2, or 4 for RPBAT).  Returns (stage12, o_spec).

    stage12(genome32, genome2o, counter2, counter3, index_all, pnib,
            lens, is_ga, scode, max_diffs_r) -> (R, 4) i32 records:
      col0 = status | flags << 3   (flags incl. the ambiguous bit)
      col1 = candidate diffs (pre-alignment; 0 for exact)
      col2 = genome position (u32 bitcast)
      col3 = winner alignment score (REC_ALIGNED only)
    pnib/lens/is_ga are laid out DENSELY: unit row per*r + u belongs to
    read r (empty reads upload zero-length rows); scode is the (per,)
    strand-code pattern; max_diffs_r is int(valid_frac * len) per read
    (host-computed: valid_frac is an arbitrary CLI float).

    device_tb (default env ABISMAL_TPU_DEVTB, on): also run the winner's
    traceback on device; the output becomes ONE packed (R, 8 + TB_NOPS)
    i32 row per read [rec(4) | cig_meta(4) | cig_ops(TB_NOPS)] with
    cig_meta = [n_ops | -1, soft_bottom, soft_top, new_pos] and cig_ops
    run-length codes in walk order -- the host reverses ops, adds soft
    clips and recovers NM (edit_distance), with NO per-read aligner call.
    (A single packed array keeps the device->host collect to one device->host
    copy per chunk.)"""
    from ..kernels.banded_align import BW_MAX, QOFF, build_banded_scorer

    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    k_slots = int(os.environ.get("ABISMAL_TPU_K_SLOTS", k_slots))
    jobs_per_read = int(os.environ.get("ABISMAL_TPU_JOBS_PER_READ",
                                       jobs_per_read))
    if device_tb is None:
        device_tb = os.environ.get("ABISMAL_TPU_DEVTB", "1") == "1"
    memo_key = (lmax, max_candidates, n_index2, n_index3, per,
                cand_per_unit, k_slots, jobs_per_read, interpret, cut,
                ext_iters, device_tb, ext_pool)
    if memo_key in _stage12_memo:
        return _stage12_memo[memo_key]
    jax, jnp = _jm()
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, tp=False,
                              cut=cut if cut in CORE_CUTS else None,
                              ext_iters=ext_iters, ext_pool=ext_pool)
    scorer = build_banded_scorer(lmax, interpret=interpret)
    tb_block = build_tb_block(lmax, interpret=interpret) if device_tb \
        else None
    K = k_slots
    WW3 = lmax + QOFF  # v3 window rows per job
    F_RC, F_SECONDARY, F_A_RICH = 0x10, 0x100, 0x1000
    POS_EMPTY = np.uint32(0xFFFFFFFF)

    def stage12(genome32, genome2o, counter2, counter3, index_all,
                pnib, lens, is_ga, scode, max_diffs_r):
        B = pnib.shape[0]
        R = B // per
        # job budget, padded to whole scorer blocks; the job arrays keep
        # at least one block so a zero budget (every read with a hit falls
        # back) still traces
        jcap = ((jobs_per_read * R + 127) // 128) * 128
        J = max(jcap, 128)
        rlen = jnp.max(lens.reshape(R, per), axis=1)
        good_cut = rlen // 10                  # == int(0.1 * len)
        sens_gate = (2 * rlen) // 5            # == int(0.4 * len)
        max_scr = 2 * rlen
        uextra = jnp.stack(
            [jnp.repeat(good_cut, per), jnp.repeat(sens_gate, per),
             jnp.tile(scode.astype(jnp.int32), R)], axis=1)
        c = core(genome32, genome2o, counter2, counter3, index_all,
                 pnib, lens, is_ga, uextra, None)
        if "cut" in c:  # profiling cut inside the core
            return c["cut"]
        pos, d, b_of = c["pos"], c["d"], c["b_of"]
        cell_of, valid = c["cell_of"], c["valid"]
        unit_total, overflow = c["unit_total"], c["overflow"]
        extras = c["extras"]
        ncand = pos.shape[0]
        if cut == "core":  # profiling cut: candidate core only
            return jnp.stack([jnp.sum(pos.astype(jnp.int32)), jnp.sum(d),
                              jnp.sum(valid), jnp.sum(unit_total)])

        r_of = b_of // per

        # --- decision gates (constant per phase while the heap is not
        # full; see the exactness argument above); the per-read cutoffs
        # and the unit's strand code ride the megarow (core extras) ---
        phase_sp = cell_of < 2 * o_spec
        gc_of, sg_of, scode_cand = (extras[:, 0], extras[:, 1],
                                    extras[:, 2])
        gate = valid & jnp.where(phase_sp, d <= gc_of, d <= sg_of)
        is_ex = gate & (d == 0)
        nonex = gate & (d != 0)

        # --- combined event window: the first K2 GATED events of each
        # read (exact and non-exact, in discovery order) compact into ONE
        # dense (R, K2) slot table via a SINGLE scatter whose indices are
        # globally sorted -- dest = read * K2 + capped per-read gated
        # rank, where dropped/overflow lanes write all-INF rows and the
        # scatter combiner is elementwise MIN (every slot has at most one
        # non-INF writer, so min reconstitutes its row exactly); the
        # scatter declares its indices sorted.  Slot budget: reads keep
        # <= 48 non-exact events (heap_would_fill falls back above that),
        # so K2 = K + 14 slack covers the typical <= 8 exact duplicates;
        # reads whose events
        # overrun the window are decided only when the windowed prefix
        # already proves exact ambiguity (see ex_over_fb), else they take
        # the exact host path -- correctness never depends on K2. ---
        span = jnp.sum(unit_total.reshape(R, per), axis=1)
        rstart = jnp.cumsum(span) - span
        rend = jnp.minimum(rstart + span, ncand)
        rst_c = jnp.minimum(rstart, ncand)
        K2 = ((K + 14 + 15) // 16) * 16
        gt = gate.astype(jnp.int32)
        g_inc = jnp.cumsum(gt)
        g_exc = g_inc - gt
        g_at = jnp.concatenate([g_exc, g_inc[-1:]])
        n_gated = g_at[rend] - g_at[rst_c]
        ex_at = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(is_ex.astype(jnp.int32))])
        total_ex = ex_at[rend] - ex_at[rst_c]
        # 49 non-exact inserts fill the 50-slot heap (sentinel occupies
        # slot 0); refined below by the sure-ambig abort argument
        heap_would_fill = (n_gated - total_ex) > 48
        # propagate each read's base gated-prefix along its candidate
        # span with an R-update mark + running max (g_at non-decreasing),
        # not a per-candidate gather
        base_of = jax.lax.associative_scan(
            jnp.maximum,
            jnp.zeros(ncand + 1, jnp.int32).at[rst_c].max(
                g_at[rst_c])[:ncand])
        wslot = g_exc - base_of  # per-read gated rank (flat for drops)
        keepw = gate & (wslot < K2)
        dest = r_of * K2 + jnp.minimum(wslot, K2 - 1)
        # diffs biased by +512 into the 10-bit field (as stage1 does):
        # IUPAC genome nibbles can drive the popcount distance negative,
        # and a raw negative d would smear sign bits over scode.
        # Duplicate (pos, scode) slots provably share d (d is a function
        # of (unit, pos)), so packing d under the sort key cannot reorder.
        scd = (scode_cand << 10) | ((d + 512) & 1023)
        # column 3 carries the global candidate (discovery) index: the
        # sure-ambig refinement below compares discovery times of the
        # ambiguity-setting exact event and the heap-filling insert
        INF32 = 0x7FFFFFFF
        cidx = jnp.arange(ncand, dtype=jnp.int32)
        rows4 = jnp.where(
            keepw[:, None],
            jnp.stack([jax.lax.bitcast_convert_type(pos, jnp.int32), scd,
                       r_of, cidx], axis=1),
            INF32)
        slotsA = jnp.full((R * K2, 4), INF32, jnp.int32).at[dest].min(
            rows4, indices_are_sorted=True)
        if cut == "compact":  # profiling cut: + gates/prefixes/slot scatter
            return jnp.stack([jnp.sum(slotsA), jnp.sum(dest),
                              jnp.sum(total_ex), jnp.sum(heap_would_fill)])

        # --- window reductions, all dense (R, K2) vector ops ---
        st = slotsA.reshape(R, K2, 4)
        wocc = st[:, :, 2] < R  # empty slots carry INF in every column
        wpos = jax.lax.bitcast_convert_type(st[:, :, 0], jnp.uint32)
        wscd = st[:, :, 1]
        wcidx = st[:, :, 3]
        # exact-match tracking (update_exact_match, abismal.cpp:347-355):
        # first exact event in discovery order (= lowest exact slot);
        # ambiguous iff any exact event at a different (pos, flags)
        is_exW = wocc & ((wscd & 1023) == 512)  # d == 0 after the bias
        k2idx = jnp.arange(K2, dtype=jnp.int32)[None, :]
        j0 = jnp.min(jnp.where(is_exW, k2idx, K2), axis=1)
        has_ex = j0 < K2
        j0c = jnp.minimum(j0, K2 - 1)[:, None]
        e_pos0 = jnp.take_along_axis(wpos, j0c, axis=1)[:, 0]
        e_s0 = jnp.take_along_axis(wscd >> 10, j0c, axis=1)[:, 0]
        mism = is_exW & ((wpos != e_pos0[:, None])
                         | ((wscd >> 10) != e_s0[:, None]))
        ex_ambig = jnp.any(mism, axis=1)
        # exact events past the window: decided only if already ambiguous
        ex_over = total_ex > jnp.sum(is_exW.astype(jnp.int32), axis=1)

        # --- sure-ambig heap-fill refinement: the reference ABORTS a
        # read's seeding the moment a second distinct exact match is
        # accepted (res.sure_ambig, checked per candidate in check_hits,
        # abismal.cpp:1133), and an exact-match read's output never
        # consults the candidate heap (align_se_candidates returns
        # res.best immediately, abismal.cpp:1443-1447).  So when the
        # ambiguity-setting exact event is discovered BEFORE the 49th
        # accepted non-exact insert (the heap fill), the heap never
        # fills in the reference and the constant-cutoff model stays
        # exact: every post-abort event is dead except that it could
        # only re-set the already-set ambiguity bit.  Those reads --
        # repeat-region reads, the dominant heap-fill class -- need no
        # host fallback.  (Before the fill no eviction happens, so the
        # exact track itself is eviction-independent here even with
        # IUPAC-negative diffs.)  idx_fill is the windowed 49th non-exact
        # event's discovery index; when that insert falls PAST the window
        # it is later than every windowed event, so INF is sound.
        idx_amb = jnp.min(jnp.where(mism, wcidx, INF32), axis=1)
        nonexW = wocc & ~is_exW
        nxcum = jnp.cumsum(nonexW.astype(jnp.int32), axis=1)
        is49 = nonexW & (nxcum == 49)
        idx_fill = jnp.min(jnp.where(is49, wcidx, INF32), axis=1)
        heap_fb = heap_would_fill & ~(ex_ambig & (idx_amb < idx_fill))

        # dedup-sort by (pos, flags) (prepare_for_alignments,
        # abismal.cpp:429-439); empty slots sort last (pos forced to the
        # u32-max sentinel, which exceeds any genome position)
        posKi, scdK = jax.lax.sort(
            (jnp.where(wocc, wpos, POS_EMPTY),
             jnp.where(wocc, wscd, INF32)), dimension=1, num_keys=2)
        posK = posKi
        sK = scdK >> 10
        dK = jnp.where(scdK == INF32, INF32, (scdK & 1023) - 512)  # unbias
        filled = posK != POS_EMPTY
        dup = jnp.concatenate(
            [jnp.zeros((R, 1), bool),
             (posK[:, 1:] == posK[:, :-1]) & (sK[:, 1:] == sK[:, :-1])],
            axis=1)
        candm = filled & ~dup
        # valid_hit (strict <); d == 0 slots are excluded: they exist
        # only on has_ex reads, whose record is decided by the exact
        # track above without consulting scores (abismal.cpp:1443-1447),
        # so scoring them would only burn job budget
        vh = candm & (dK < sens_gate[:, None]) & (dK != 0)
        if cut == "decide":  # profiling cut: + gates/compaction/sort
            return jnp.stack([jnp.sum(posK.astype(jnp.int32)), jnp.sum(dK),
                              jnp.sum(vh), jnp.sum(has_ex)])

        # --- batched banded scoring of every valid hit ---
        bwK = 2 * jnp.minimum(dK, max_diffs_r[:, None]) + 1
        # a true band beyond the kernel's BW_MAX (large -m on long reads)
        # cannot be scored exactly on device: fall back, don't clamp
        # (bwK < 0 is the empty-slot sentinel dK = 0x7FFFFFFF overflowing)
        bw_over = jnp.any(vh & (bwK >= 0) & (bwK > BW_MAX), axis=1)
        bwK = jnp.where(bwK < 0, BW_MAX, jnp.minimum(BW_MAX, bwK))
        rc = (sK & F_RC) != 0
        ar = (sK & F_A_RICH) != 0
        if per == 2:
            uoff = rc.astype(jnp.int32)
        else:
            uoff = jnp.where(rc, jnp.where(ar, 2, 3),
                             jnp.where(ar, 1, 0))
        rows_r = jnp.arange(R, dtype=jnp.int32)[:, None]
        qrowK = rows_r * per + uoff
        jm = vh.reshape(-1).astype(jnp.int32)
        jexc = jnp.cumsum(jm) - jm
        job_ok = (jm != 0) & (jexc < jcap)
        job_over = (jm != 0) & (jexc >= jcap)
        job_fb = jnp.any(job_over.reshape(R, K2), axis=1)
        jdest = jnp.where(job_ok, jexc, J)
        # ONE row scatter for the four job fields
        jfill = jnp.concatenate(
            [jnp.zeros((J + 1, 1), jnp.int32),
             jnp.full((J + 1, 1), 32767, jnp.int32),
             jnp.ones((J + 1, 1), jnp.int32),
             jnp.zeros((J + 1, 1), jnp.int32)], axis=1)
        jrows = jfill.at[jdest].set(jnp.stack(
            [qrowK.reshape(-1),
             jax.lax.bitcast_convert_type(posK, jnp.int32).reshape(-1),
             bwK.reshape(-1), jnp.repeat(rlen, K2)], axis=1))
        junit = jrows[:J, 0]
        jpos = jax.lax.bitcast_convert_type(jrows[:J, 1], jnp.uint32)
        jbw, jqsz = jrows[:J, 2], jrows[:J, 3]
        # job prep: ONE unit-row gather for the query (the scorer's row
        # reparametrization needs no per-job query shift) and ONE
        # overlapped genome-row gather for the window, nibble-aligned by a
        # log-roll of vector ops -- 2 row-gathers/job instead of ~500
        # element-gathers/job
        rows = pnib[junit]
        q = jnp.stack([rows & np.uint8(0xF), rows >> np.uint8(4)],
                      axis=2).reshape(J, -1)
        g0 = jpos + ((jbw - 1) // 2).astype(jnp.uint32) - np.uint32(QOFF)
        grow = (g0 >> np.uint32(9)).astype(jnp.int32)
        A = genome2o[grow]  # (J, 128) u32 = 1024 nibbles from 512*grow
        if WW3 + 511 > 1024:
            # long reads (lmax > 453): one row doesn't cover worst-case
            # offset + window; splice the next 512 nibbles from the first
            # half of row grow+2 (overlap stride 512 nibbles/row)
            A = jnp.concatenate([A, genome2o[grow + 2][:, :64]], axis=1)
        nwords = A.shape[1]
        nshift = (np.uint32(4)
                  * jnp.arange(8, dtype=jnp.uint32))[None, None, :]
        nib = ((A[:, :, None] >> nshift)
               & np.uint32(0xF)).astype(jnp.uint8).reshape(J, nwords * 8)
        off = (g0 & np.uint32(511)).astype(jnp.int32)
        for s_ in (256, 128, 64, 32, 16, 8, 4, 2, 1):
            rolled = jnp.concatenate(
                [nib[:, s_:], jnp.zeros((J, s_), jnp.uint8)], axis=1)
            nib = jnp.where((off & s_)[:, None] != 0, rolled, nib)
        win = nib[:, :WW3]
        if cut == "jobs":  # profiling cut: + job build/gathers, no scorer
            return jnp.stack([jnp.sum(q.astype(jnp.int32)),
                              jnp.sum(win.astype(jnp.int32)),
                              jnp.sum(jbw), jnp.sum(jqsz)])
        scores_j = scorer(q, win, jbw[:, None], jqsz[:, None])[:, 0]
        if cut == "score":  # profiling cut: + banded scorer
            return jnp.stack([jnp.sum(scores_j), jnp.sum(jbw),
                              jnp.sum(jqsz), jnp.sum(vh)])
        scrK = jnp.where(
            job_ok.reshape(R, K2),
            scores_j[jnp.minimum(jexc, J - 1)].reshape(R, K2), 0)

        # --- winner selection (align_se_candidates scan semantics,
        # abismal.cpp:1435-1497): best = first occurrence of the max
        # score in sorted order (updates are strict improvements, so the
        # running best after the last update is that first occurrence);
        # ambiguous iff any LATER valid hit ties the max at a distinct
        # position (ties before the last update are erased by it) ---
        M = jnp.max(jnp.where(vh, scrK, 0), axis=1)
        kidx = jnp.arange(K2, dtype=jnp.int32)[None, :]
        isM = vh & (scrK == M[:, None]) & (M[:, None] > 0)
        istar = jnp.min(jnp.where(isM, kidx, K2), axis=1)
        ist = jnp.minimum(istar, K2 - 1)[:, None]
        bpos = jnp.take_along_axis(posK, ist, axis=1)[:, 0]
        bs = jnp.take_along_axis(sK, ist, axis=1)[:, 0]
        bd = jnp.take_along_axis(dK, ist, axis=1)[:, 0]
        # |pos - best_pos| computed in uint32 (x64 stays disabled)
        pdiff = jnp.where(posK >= bpos[:, None], posK - bpos[:, None],
                          bpos[:, None] - posK)
        distinct = jnp.where(M[:, None] == max_scr[:, None],
                             posK != bpos[:, None], pdiff > 3)
        amb = jnp.any(isM & (kidx > istar[:, None]) & distinct, axis=1)
        # M == 0: best never updates (best_pos stays 0), so every valid
        # hit with score 0 is a distinct-position tie against it
        amb0 = jnp.any(vh & (scrK == 0), axis=1) & (M == 0)

        # --- per-read records ---
        # window-overrun refinement: window slots fill in discovery
        # order, so a read whose WINDOWED events already contain its
        # first exact match AND a distinct second one is fully decided
        # -- the record is (REC_EXACT, first exact's flags/pos, ambig),
        # and every beyond-window exact event could only re-set the
        # already-set ambiguity bit (update_exact_match,
        # abismal.cpp:347-355).  Only overruns on reads NOT yet
        # known-ambiguous need the exact host path.
        ex_over_fb = ex_over & ~(has_ex & ex_ambig)
        unit_fb = jnp.any(overflow.reshape(R, per), axis=1)
        if cut == "fbstats":  # diagnostics: per-read fallback causes
            return jnp.stack(
                [unit_fb, heap_would_fill, heap_fb, job_fb, bw_over,
                 ex_over_fb, has_ex, ex_ambig], axis=1).astype(jnp.int32)
        fb = (unit_fb | heap_fb | job_fb | bw_over | ex_over_fb
              | ((rlen > 0) & (rlen < DEVICE_MIN_LEN)))
        aligned = (~has_ex) & (M > 0)
        status = jnp.where(fb, REC_FALLBACK,
                           jnp.where(has_ex, REC_EXACT,
                                     jnp.where(aligned, REC_ALIGNED,
                                               REC_UNMAPPED)))
        sec = jnp.where(has_ex, ex_ambig, jnp.where(aligned, amb, amb0))
        flags = jnp.where(has_ex, e_s0, jnp.where(aligned, bs, 0))
        flags = flags | jnp.where(sec, F_SECONDARY, 0)
        rd = jnp.where(has_ex, 0, bd)
        rp = jnp.where(has_ex, e_pos0, jnp.where(aligned, bpos, 0))
        rec = jnp.stack([
            status | (flags << 3), rd,
            jax.lax.bitcast_convert_type(rp, jnp.int32),
            jnp.where(aligned, M, 0)], axis=1)
        if not device_tb:
            return rec

        # --- on-device traceback for winners (build_traceback,
        # AbismalAlign.hpp:388-440 / native build_traceback): removes the
        # per-winner host alignment call (VERDICT r4 ask #4).  The tracer
        # kernel re-runs the winner's banded DP storing packed
        # (arrow, positive) nibbles -- 8 band rows per i32 word -- plus
        # the row-major-first argmax cell; a lane-parallel while_loop then
        # walks the arrows, emitting run-length cigar ops in walk order.
        # The host reverses the ops, adds the geometric soft clips, and
        # recovers NM via edit_distance -- no aligner call.  Reads whose
        # op count exceeds the buffer get n_ops = -1 and take the host
        # traceback for that read alone (output-identical).
        do_tb = aligned & ~fb
        J2 = ((R + 127) // 128) * 128
        padR = J2 - R
        wunit = jnp.take_along_axis(qrowK, ist, axis=1)[:, 0]
        wbw = jnp.take_along_axis(bwK, ist, axis=1)[:, 0]
        wbw = jnp.pad(jnp.where(do_tb, wbw, 1), (0, padR),
                      constant_values=1)
        wqsz = jnp.pad(jnp.where(do_tb, rlen, 0), (0, padR))
        wpos = jnp.pad(jnp.where(do_tb, bpos, np.uint32(0)), (0, padR))
        wrows = pnib[jnp.pad(wunit, (0, padR))]
        q2 = jnp.stack([wrows & np.uint8(0xF), wrows >> np.uint8(4)],
                       axis=2).reshape(J2, -1)
        g02 = wpos + ((wbw - 1) // 2).astype(jnp.uint32) - np.uint32(QOFF)
        grow2 = (g02 >> np.uint32(9)).astype(jnp.int32)
        A2 = genome2o[grow2]
        if WW3 + 511 > 1024:
            A2 = jnp.concatenate([A2, genome2o[grow2 + 2][:, :64]], axis=1)
        nw2 = A2.shape[1]
        nib2 = ((A2[:, :, None]
                 >> (np.uint32(4)
                     * jnp.arange(8, dtype=jnp.uint32))[None, None, :])
                & np.uint32(0xF)).astype(jnp.uint8).reshape(J2, nw2 * 8)
        off2 = (g02 & np.uint32(511)).astype(jnp.int32)
        for s_ in (256, 128, 64, 32, 16, 8, 4, 2, 1):
            rolled = jnp.concatenate(
                [nib2[:, s_:], jnp.zeros((J2, s_), jnp.uint8)], axis=1)
            nib2 = jnp.where((off2 & s_)[:, None] != 0, rolled, nib2)
        win2 = nib2[:, :WW3]
        opsR, meta = tb_block(q2, win2, wbw, wqsz, wpos,
                              jnp.pad(do_tb, (0, padR)))
        # ONE packed output row per read: [rec(4) | meta(4) | ops(NOPS)],
        # so each chunk is collected in a single device->host fetch
        return jnp.concatenate([rec, meta[:R], opsR[:R]], axis=1)

    result = (jax.jit(stage12), o_spec)
    _stage12_memo[memo_key] = result
    return result


_stage12pe_memo = {}


def build_stage12pe(lmax: int, max_candidates: int, n_index2: int,
                    n_index3: int, per: int = 4,
                    cand_per_unit: int | None = None,
                    k_slots: int = 32, jobs_per_unit: int = 8,
                    interpret: bool = False, ext_iters: int = 31,
                    ext_pool: int | None = None, cut: str | None = None):
    """Fused device stage-1+2 for paired-end mapping: ONE jitted program
    runs candidate generation (the shared core), the reference's
    pe_candidates acceptance gates, and banded scoring of every
    kept candidate, returning a compact per-UNIT candidate slot table
    (8 B/slot) that the native engine consumes directly (fill-from-slots
    + injected-score best_pair; _engine.cpp) -- no event stream, no
    re-seeding, no host score pass.

    Exactness argument: while a pe_candidates heap is NOT full its
    acceptance cutoff is constant per phase -- the sentinel v[0] holds
    the max diffs int(0.4*len), so cutoff == good_cutoff (len/10) during
    the specific phase (set_specific + min-with-front) and == v[0].d
    during the sensitive phase (abismal.cpp:776-852).  Acceptance is
    then a pure per-candidate predicate in discovery order.  Units whose
    accepted count would FILL the 32-slot heap (> 31 inserts, where the
    capacity-doubling and pop-replacement paths begin) fall back to
    native seeding, as do units with core overflow or a band width
    beyond the banded scorer's BW_MAX.

    stage12pe(genome32, genome2o, counter2, counter3, index_all, pnib,
              lens, is_ga, max_diffs_u, pe_dist) -> (B, 2K + 6) i32,
    one packed row per unit [pos(K) | ds(K) | cnt | mate-slice(5)]:
      pos  K u32 bitcast  candidate genome positions, discovery order
      ds   K i32          (diffs << 16) | (score & 0xFFFF)
      cnt  1 i32          accepted count, or -1 => native-seeding fallback
      mate 5 i32          unit per*r + u carries mate[r, 5u:5u+5] of the
           (B/per, O*10) per-orientation local mating sweep records (the
           device-resident best_pair; see the inline exactness notes)
    pe_dist: (2,) i32 = (pe_min, pe_max) concordance window bounds.
    One packed array = one device->host copy per chunk."""
    from ..kernels.banded_align import (
        ALN_MATCH, BW_MAX, QOFF, build_banded_scorer,
    )

    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    jobs_per_unit = int(os.environ.get("ABISMAL_TPU_JOBS_PER_UNIT",
                                       jobs_per_unit))
    memo_key = (lmax, max_candidates, n_index2, n_index3, per,
                cand_per_unit, k_slots, jobs_per_unit, interpret, ext_iters,
                ext_pool, cut)
    if memo_key in _stage12pe_memo:
        return _stage12pe_memo[memo_key]
    jax, jnp = _jm()
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, tp=False, ext_iters=ext_iters,
                              ext_pool=ext_pool,
                              cut=cut if cut in CORE_CUTS else None)
    scorer = build_banded_scorer(lmax, interpret=interpret)
    K = k_slots
    WW3 = lmax + QOFF

    def stage12pe(genome32, genome2o, counter2, counter3, index_all,
                  pnib, lens, is_ga, max_diffs_u, pe_dist):
        B = pnib.shape[0]
        J = ((jobs_per_unit * B + 127) // 128) * 128
        good_cut = lens // 10                 # == readlen / 10
        sens_gate = (2 * lens) // 5           # == int(0.4 * len), sentinel
        uextra = jnp.stack([good_cut, sens_gate, max_diffs_u, lens], axis=1)
        c = core(genome32, genome2o, counter2, counter3, index_all,
                 pnib, lens, is_ga, uextra, None)
        if "cut" in c:  # profiling cut inside the core
            return c["cut"]
        pos, d, b_of = c["pos"], c["d"], c["b_of"]
        cell_of, valid = c["cell_of"], c["valid"]
        unit_start, unit_total = c["unit_start"], c["unit_total"]
        overflow = c["overflow"]
        extras = c["extras"]
        ncand = pos.shape[0]

        # per-unit cutoffs ride the megarow (core extras)
        phase_sp = cell_of < 2 * o_spec
        gate = valid & jnp.where(phase_sp, d <= extras[:, 0],
                                 d <= extras[:, 1])

        # per-unit slot index among accepted candidates, discovery order
        acc = gate.astype(jnp.int32)
        c_inc = jnp.cumsum(acc)
        c_exc = c_inc - acc
        c_at = jnp.concatenate([c_exc, c_inc[-1:]])
        ust_c = jnp.minimum(unit_start, ncand)
        base = c_at[ust_c]
        uend_at = jnp.minimum(unit_start + unit_total, ncand)
        n_acc = c_at[uend_at] - base
        heap_fb = n_acc > K - 1  # insert #32 fills the heap
        if cut == "pegate":  # profiling cut: + gates/cumsum/unit spans
            return jnp.stack([jnp.sum(c_exc), jnp.sum(n_acc),
                              jnp.sum(heap_fb), jnp.sum(base)])
        base_of = jax.lax.associative_scan(
            jnp.maximum,
            jnp.zeros(ncand + 1, jnp.int32).at[ust_c].max(base)[:ncand])
        slot_u = c_exc - base_of
        keep = gate & (slot_u < K - 1)
        if cut == "pescan":  # profiling cut: + per-candidate base scan
            return jnp.stack([jnp.sum(base_of), jnp.sum(slot_u),
                              jnp.sum(keep), jnp.sum(n_acc)])
        # No per-candidate slot scatter: kept candidates are densely
        # ranked by the job build below (jexc counts keep lanes), so
        # slot (u, k)'s (pos, d) is GATHERED from the job rows at
        # jrank = kbase + k after scoring -- a (B, K) gather replaces a
        # (gflat -> B*K) scatter-min.  Dead slots (beyond the accepted
        # count) read as INF32/0x7FFFFFFF exactly as the old scatter's
        # unwritten rows did; the host replay only reads slots < sl_cnt.
        INF32 = 0x7FFFFFFF
        if cut == "pecompact":  # profiling cut: + gates/slot ranks
            return jnp.stack([jnp.sum(slot_u), jnp.sum(n_acc),
                              jnp.sum(heap_fb), jnp.sum(keep)])

        # --- score every kept candidate ---
        md = extras[:, 2]
        bw_c = 2 * jnp.minimum(d, md) + 1
        # IUPAC codes can make d negative; the reference's size_t cast then
        # selects the full band (band_width, AbismalAlign.hpp:332-334)
        bw_c = jnp.where(bw_c < 0, BW_MAX, bw_c)
        jm = keep.astype(jnp.int32)
        k_inc = jnp.cumsum(jm)
        jexc = k_inc - jm
        job_ok = keep & (jexc < J)
        # per-unit fallback flags from prefix arithmetic (candidate spans
        # are contiguous per unit), not (gflat -> B) scatters
        ustart_c = jnp.minimum(unit_start, ncand)
        k_atx = jnp.concatenate([jnp.zeros(1, jnp.int32), k_inc])
        job_fb = k_atx[uend_at] > jnp.maximum(J, k_atx[ustart_c])
        bwm = (keep & (bw_c > BW_MAX)).astype(jnp.int32)
        b_atx = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                 jnp.cumsum(bwm)])
        bw_fb = (b_atx[uend_at] - b_atx[ustart_c]) > 0
        jdest = jnp.where(job_ok & (bw_c <= BW_MAX), jexc, J)
        # ONE row scatter for the job fields, kept at FOUR i32 columns
        # (16 B rows): d rides the high half of the qsz
        # column (d <= lmax <= 512, qsz < 2^16).  bw-overflow jobs fall
        # out of jdest and are detected per unit below (their hole rows
        # carry fill values, read only by units already flagged bw_fb)
        jfill = jnp.concatenate(
            [jnp.zeros((J + 1, 1), jnp.int32),
             jnp.full((J + 1, 1), 32767, jnp.int32),
             jnp.ones((J + 1, 1), jnp.int32),
             jnp.zeros((J + 1, 1), jnp.int32)], axis=1)
        jrows = jfill.at[jdest].set(jnp.stack(
            [b_of, jax.lax.bitcast_convert_type(pos, jnp.int32),
             jnp.minimum(bw_c, BW_MAX),
             (d << 16) | extras[:, 3]], axis=1))
        junit = jrows[:J, 0]
        jpos = jax.lax.bitcast_convert_type(jrows[:J, 1], jnp.uint32)
        jbw, jqsz = jrows[:J, 2], jrows[:J, 3] & 0xFFFF

        rows = pnib[junit]
        q = jnp.stack([rows & np.uint8(0xF), rows >> np.uint8(4)],
                      axis=2).reshape(J, -1)
        g0 = jpos + ((jbw - 1) // 2).astype(jnp.uint32) - np.uint32(QOFF)
        grow = (g0 >> np.uint32(9)).astype(jnp.int32)
        A = genome2o[grow]  # 128-word rows = 1024 nibbles from 512*grow
        if WW3 + 511 > 1024:
            A = jnp.concatenate([A, genome2o[grow + 2][:, :64]], axis=1)
        nwords = A.shape[1]
        nshift = (np.uint32(4)
                  * jnp.arange(8, dtype=jnp.uint32))[None, None, :]
        nib = ((A[:, :, None] >> nshift)
               & np.uint32(0xF)).astype(jnp.uint8).reshape(J, nwords * 8)
        off = (g0 & np.uint32(511)).astype(jnp.int32)
        for s_ in (256, 128, 64, 32, 16, 8, 4, 2, 1):
            rolled = jnp.concatenate(
                [nib[:, s_:], jnp.zeros((J, s_), jnp.uint8)], axis=1)
            nib = jnp.where((off & s_)[:, None] != 0, rolled, nib)
        win = nib[:, :WW3]
        if cut == "pejobs":  # profiling cut: + job build/window gathers
            return jnp.stack([jnp.sum(q.astype(jnp.int32)),
                              jnp.sum(win.astype(jnp.int32)),
                              jnp.sum(jbw), jnp.sum(jqsz)])
        scores_j = scorer(q, win, jbw[:, None], jqsz[:, None])[:, 0]
        # the reference never aligns a zero-diffs candidate: it scores it
        # best_single_score = ALN_MATCH * len (AbismalAlign.hpp align);
        # with IUPAC genome codes the popcount distance can be 0 where the
        # DP would find a mismatch, so the DP score must not stand there
        scores_j = jnp.where((jrows[:J, 3] >> 16) == 0, ALN_MATCH * jqsz,
                             scores_j)
        if cut == "pescore":  # profiling cut: + banded scorer
            return jnp.stack([jnp.sum(scores_j), jnp.sum(jbw),
                              jnp.sum(jqsz), jnp.sum(n_acc)])

        # slot (u, k) holds the unit's k-th kept candidate, whose job rank
        # is the unit's kept-prefix base + k: (B, K) gathers of score,
        # pos and d from the job rows replace the per-candidate slot
        # scatter (see the note above)
        kbase = k_atx[ust_c]
        kidx = jnp.arange(K, dtype=jnp.int32)[None, :]
        slot_live = kidx < jnp.minimum(n_acc, K - 1)[:, None]
        jrank = jnp.minimum(kbase[:, None] + kidx, J - 1)
        live = slot_live & (jrank < J)
        scrK = jnp.where(live, scores_j[jrank], 0)

        fb = overflow | heap_fb | bw_fb | job_fb | (
            (lens > 0) & (lens < DEVICE_MIN_LEN))
        cnt = jnp.where(fb, -1, n_acc)
        posKm = jnp.where(
            live, jax.lax.bitcast_convert_type(jrows[:J, 1], jnp.uint32)[
                jrank], np.uint32(INF32))
        dKm = jnp.where(live, jrows[:J, 3][jrank] >> 16, INF32)
        ds = (dKm << 16) | (scrK & 0xFFFF)

        # --- device mating sweep (best_pair, abismal.cpp:1722-1831):
        # per (pair, orientation), the LOCAL sweep result over the
        # pos-sorted deduped slot grids.  The host replays the tiny
        # orientation loop with full sequential state (cross-orientation
        # updates compare against POST-traceback edit distances and a
        # discordant-after-clip winner RESETS the state, both of which
        # need the winner's traceback), so the device returns each
        # orientation's local best independently:
        #   [has_pairs, scr, pos1, pos2, d1, d2, scr1_stale, scr2,
        #    eq_after, 0] x O orientations.
        # Exact within an orientation: the winner is the first pair by
        # (scr desc, diff-sum asc, traversal order asc) -- updates are
        # strict improvements -- eq_after reproduces the tie->ambig rule,
        # and scr1_stale reproduces the reference's memoization quirk
        # (the last COMPUTED end-1 score at the winning update,
        # abismal.cpp:1793-1799) from the first-window/zero-score
        # computation pattern.
        Rp = B // per
        O = per // 2
        BIGU = np.uint32(0xFFFFFFFF)
        iK = jnp.arange(K, dtype=jnp.int32)
        # Sweep order WITHOUT a physical sort: the stable (pos asc, slot
        # asc) permutation is computed as pairwise RANKS over the K x K
        # grids the sweep builds anyway, instead of a variadic (B, K)
        # sort (the trade is not measured on the GPU).  Traversal
        # order, dedup and winner extraction are all RELATIVE statements
        # about that permutation, so ranks substitute exactly: rank
        # compares replace sorted-index compares, rank minima replace
        # sorted-axis minima, and rank-match selects replace
        # take_along_axis on the sorted arrays.
        posM = jnp.where(slot_live, posKm, BIGU)
        pi = posM[:, :, None]
        pj = posM[:, None, :]
        jlt = iK[None, None, :] < iK[None, :, None]  # slot j before slot i
        eqp = pi == pj
        rank = jnp.sum(((pj < pi) | (eqp & jlt)).astype(jnp.int32), axis=2)
        dup = jnp.any(eqp & jlt, axis=2)  # an earlier slot holds this pos
        vM = slot_live & ~dup
        if cut == "pesort":  # profiling cut: + slot-grid ranks/dedup
            return jnp.stack([jnp.sum(jax.lax.bitcast_convert_type(
                posM, jnp.int32)), jnp.sum(rank), jnp.sum(vM),
                jnp.sum(dup)])
        posP = posM.reshape(Rp, per, K)
        dP = dKm.reshape(Rp, per, K)
        sP = scrK.reshape(Rp, per, K)
        vP = vM.reshape(Rp, per, K)
        rP = rank.reshape(Rp, per, K)
        lensP = lens.reshape(Rp, per)
        mins, maxs = pe_dist[0].astype(jnp.uint32), pe_dist[1].astype(
            jnp.uint32)

        def sel(a, rr, rw):
            """The element of a whose rank equals rw (ranks are unique
            per row; no match -- winner-less rows -- selects 0)."""
            return jnp.sum(jnp.where(rr == rw[:, None], a,
                                     jnp.zeros_like(a)), axis=1)

        recs = []
        for o in range(O):
            p1, d1, s1, v1, r1 = (posP[:, 2 * o], dP[:, 2 * o],
                                  sP[:, 2 * o], vP[:, 2 * o], rP[:, 2 * o])
            p2, d2, s2, v2, r2 = (posP[:, 2 * o + 1], dP[:, 2 * o + 1],
                                  sP[:, 2 * o + 1], vP[:, 2 * o + 1],
                                  rP[:, 2 * o + 1])
            lim = p2 + lensP[:, 2 * o + 1, None].astype(jnp.uint32)  # (Rp,K)
            # grid axes: i over res1 slots (axis 1), j over res2 (axis 2)
            limj = lim[:, None, :]
            p1i = p1[:, :, None]
            conc = (v1[:, :, None] & v2[:, None, :]
                    & (p1i + mins <= limj) & (p1i + maxs >= limj))
            scrP = s1[:, :, None] + s2[:, None, :]
            sdP = d1[:, :, None] + d2[:, None, :]
            # traversal order: res2 rank outer ascending, res1 rank inner
            ordg = r2[:, None, :] * K + r1[:, :, None]
            M = jnp.max(jnp.where(conc, scrP, -1), axis=(1, 2))
            isM = conc & (scrP == M[:, None, None])
            key2 = sdP * (K * K) + ordg
            k2m = jnp.min(jnp.where(isM, key2, 0x3FFFFFFF), axis=(1, 2))
            sd_w = k2m // (K * K)
            ord_w = k2m % (K * K)
            r1_w = ord_w % K
            r2_w = ord_w // K
            eq_after = jnp.any(isM & (sdP == sd_w[:, None, None])
                               & (ordg > ord_w[:, None, None]), axis=(1, 2))
            # stale end-1 score: last COMPUTED (first window for its j1,
            # or zero-score recompute) at or before the winning update
            firstr2 = jnp.min(jnp.where(conc, r2[:, None, :], K), axis=2)
            computed = conc & ((r2[:, None, :] == firstr2[:, :, None])
                               | (s1[:, :, None] == 0))
            cord = jnp.where(computed & (ordg <= ord_w[:, None, None]),
                             ordg, -1)
            cmax = jnp.max(cord, axis=(1, 2))
            r1_c = jnp.maximum(cmax, 0) % K
            # mid-sweep sure-ambig divergence guard: at the maximum
            # possible pair score (2*(l1+l2) all-match, where the
            # reference's sweep STOPS once a tie sets ambig,
            # abismal.cpp:1722-1831), IUPAC codes can make tied pairs'
            # diff-sums differ, and the device's min-diff-sum winner may
            # postdate the reference's early exit.  Flag those rare
            # orientations (slot 9) for the host's exact injected-score
            # sweep; equal diff-sums need no flag (device winner = first
            # in traversal order = the reference's, eq_after -> ambig).
            maxscr = 2 * (lensP[:, 2 * o] + lensP[:, 2 * o + 1])
            fbm = (M == maxscr) & jnp.any(
                isM & (sdP != sd_w[:, None, None]), axis=(1, 2))
            recs.append(jnp.stack([
                (M >= 0).astype(jnp.int32), M,
                jax.lax.bitcast_convert_type(sel(p1, r1, r1_w), jnp.int32),
                jax.lax.bitcast_convert_type(sel(p2, r2, r2_w), jnp.int32),
                sel(d1, r1, r1_w), sel(d2, r2, r2_w),
                sel(s1, r1, r1_c), sel(s2, r2, r2_w),
                eq_after.astype(jnp.int32), fbm.astype(jnp.int32),
            ], axis=1))
        mate = jnp.concatenate(recs, axis=1)  # (Rp, O*10)
        if cut == "pegrid":  # profiling cut: + orientation mating grids
            return jnp.stack([jnp.sum(mate), jnp.sum(cnt),
                              jnp.sum(jnp.asarray(0)), jnp.sum(n_acc)])

        # ONE packed (B, 2K + 6) i32 output row per unit:
        # [pos(K) | ds(K) | cnt(1) | mate-slice(5)] -- unit per*r + u
        # carries mate[r, 5u : 5u+5] (O*10 == 5*per always), so the whole
        # chunk collects in a single device->host copy
        return jnp.concatenate(
            [jax.lax.bitcast_convert_type(posKm, jnp.int32), ds,
             cnt[:, None], mate.reshape(B, 5)], axis=1)

    result = (jax.jit(stage12pe), o_spec)
    _stage12pe_memo[memo_key] = result
    return result


def replay_events(res, sc: int, ev_pos, ev_diffs, ev_rank, count: int,
                  o_spec: int) -> None:
    """Replays process_seeds' sequential candidate-set updates
    (abismal.cpp:1269-1375) over device-computed events.  Events arrive in
    discovery order; rank encodes (phase, offset, table, slot)."""
    boundary = o_spec * 2 * SLOT
    res.set_specific()
    i = 0
    while i < count and ev_rank[i] < boundary:
        if res.sure_ambig:
            break
        d = int(ev_diffs[i])
        if d <= res.cutoff:
            res.update(True, d, sc, int(ev_pos[i]))
        i += 1
    # skip remaining specific events after a sure-ambig abort
    while i < count and ev_rank[i] < boundary:
        i += 1
    if not res.should_do_sensitive():
        return
    res.set_sensitive()
    while i < count:
        if res.sure_ambig:
            break
        d = int(ev_diffs[i])
        if d <= res.cutoff:
            res.update(True, d, sc, int(ev_pos[i]))
        i += 1


from .engine import MappingEngine, strand_code  # noqa: E402
from .seeds import get_conv_is_ga, prep_read, process_seeds  # noqa: E402


class TpuMappingEngine(MappingEngine):
    """Mapping engine whose candidate generation runs on the accelerator.

    Extends the exact host engine: before each batch, all read/strand/
    encoding units are pushed through the jitted stage-1 program; the
    sequential decision logic replays device events, falling back to the
    host oracle for units flagged overflow.  Output is identical to the
    exact engine (and hence to the reference)."""

    def __init__(self, index, allow_ambig=False, valid_frac=0.1,
                 pe_min_dist=32, pe_max_dist=3000, lmax: int = 128,
                 unit_batch: int = 1024, device_put=None):
        device_backend()  # refuse an implicit CPU fallback
        MappingEngine.__init__(self, index, allow_ambig, valid_frac,
                               pe_min_dist, pe_max_dist)
        self.lmax = lmax
        self.unit_batch = unit_batch
        self.dev = DeviceIndex(index, device_put)
        self.stage1, self.o_spec = build_stage1(
            lmax, self.dev.max_candidates, self.dev.n_index2,
            self.dev.n_index3, ext_iters=self.dev.ext_iters
        )
        self._cache = {}
        self.n_fallback = 0
        self.n_units = 0

    # --- batch preparation -------------------------------------------------
    def _dispatch_units(self, units):
        """units: list of (key, pread_nibbles, is_ga).  Dispatches the
        device work asynchronously; returns a handle for _collect_units."""
        pre_cache = {}
        pending = []  # (chunk, device outputs) -- dispatch all, pull later
        if not units:
            return pre_cache, pending
        B = self.unit_batch
        for start in range(0, len(units), B):
            chunk = units[start : start + B]
            reads = [u[1] for u in chunk]
            if any(r.shape[0] > self.lmax for r in reads):
                # route oversized reads to the host path; process the rest
                keep = [u for u in chunk if u[1].shape[0] <= self.lmax]
                for u in chunk:
                    if u[1].shape[0] > self.lmax:
                        pre_cache[u[0]] = None
                chunk = keep
                reads = [u[1] for u in chunk]
                if not chunk:
                    continue
            preads, lens = prepare_units(reads, self.lmax)
            pad = B - len(chunk)
            if pad:
                preads = np.pad(preads, ((0, pad), (0, 0)))
                lens = np.pad(lens, (0, pad))
            is_ga = np.zeros(B, dtype=bool)
            for i, u in enumerate(chunk):
                is_ga[i] = u[2]
            thr = ((2 * lens.astype(np.int64)) // 5).astype(np.int32)
            pn = preads
            if getattr(self, "device_align", False) and self.mesh is None:
                # keep the unit matrix resident: the align program reuses
                # it for query gathers instead of re-uploading queries
                import jax

                pn = jax.device_put(preads)
            out = self._stage1_call(pn, lens, is_ga, thr)
            for arr in out:
                # start the device->host copy immediately so it overlaps
                # the native decode of earlier batches
                try:
                    arr.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    pass
            pending.append((chunk, out, pn))
        return pre_cache, pending

    def _stage1_call(self, preads, lens, is_ga, thr):
        return self.stage1(*self.dev.tables(), preads, lens, is_ga, thr)

    def _collect_units(self, dispatched):
        """Pulls dispatched device results into an event-cache dict."""
        pre_cache, pending = dispatched
        cache = dict(pre_cache)
        for chunk, (ev_dev, cf_dev), _pn in pending:
            ev = np.asarray(ev_dev)
            cf = np.asarray(cf_dev)
            count = cf & 0x3FFFFFFF
            overflow = (cf >> 30) != 0
            gpos, gmeta = ev[0], ev[1]
            prefix = np.concatenate(([0], np.cumsum(count)))
            diffs_all = (gmeta >> 22).astype(np.int32) - 512
            rank_all = (gmeta & 0x3FFFFF).astype(np.int32)
            for i, u in enumerate(chunk):
                self.n_units += 1
                if overflow[i]:
                    self.n_fallback += 1
                    cache[u[0]] = None
                else:
                    s, e = int(prefix[i]), int(prefix[i + 1])
                    cache[u[0]] = (
                        gpos[s:e], diffs_all[s:e], rank_all[s:e], e - s
                    )
        return cache

    def _run_units(self, units):
        self._cache = self._collect_units(self._dispatch_units(units))

    def _se_units(self, reads, a_rich_mode, random_pbat):
        from ..utils.dna import revcomp_str

        units = []
        for ri, (_, read) in enumerate(reads):
            if not read:
                continue
            if not random_pbat:
                conv = a_rich_mode
                units.append((
                    (ri, "f", conv), prep_read(read, conv),
                    get_conv_is_ga(strand_code("+", conv))))
                rc = revcomp_str(read.decode()).encode()
                units.append((
                    (ri, "r", not conv), prep_read(rc, not conv),
                    get_conv_is_ga(strand_code("-", conv))))
            else:
                rc = revcomp_str(read.decode()).encode()
                units.append(((ri, "f", False), prep_read(read, False),
                              get_conv_is_ga(strand_code("+", False))))
                units.append(((ri, "f", True), prep_read(read, True),
                              get_conv_is_ga(strand_code("+", True))))
                units.append(((ri, "r", False), prep_read(rc, False),
                              get_conv_is_ga(strand_code("-", True))))
                units.append(((ri, "r", True), prep_read(rc, True),
                              get_conv_is_ga(strand_code("-", False))))
        return units

    def _prepare_batch_se(self, reads, a_rich_mode, random_pbat):
        self._run_units(self._se_units(reads, a_rich_mode, random_pbat))

    def _pe_units(self, reads1, reads2, a_rich_mode, random_pbat):
        from ..utils.dna import revcomp_str

        units = []

        def add(ri, end, orient, enc, read_bytes, sc):
            if not read_bytes:
                return
            seq = read_bytes
            if orient == "r":
                seq = revcomp_str(read_bytes.decode()).encode()
            units.append(((ri, end, orient, enc), prep_read(seq, enc),
                          get_conv_is_ga(sc)))

        convs = ([a_rich_mode] if not random_pbat else [False, True])
        for ri, ((_, r1), (_, r2)) in enumerate(zip(reads1, reads2)):
            for conv in convs:
                add(ri, 1, "f", conv, r1, strand_code("+", conv))
                add(ri, 2, "r", conv, r2, strand_code("-", not conv))
                add(ri, 2, "f", not conv, r2, strand_code("+", not conv))
                add(ri, 1, "r", not conv, r1, strand_code("-", conv))
        return units

    def _prepare_batch_pe(self, reads1, reads2, a_rich_mode, random_pbat):
        self._run_units(self._pe_units(reads1, reads2, a_rich_mode,
                                       random_pbat))

    def _seeds(self, pread, sc, res, key=None):
        ev = self._cache.get(key, None) if key is not None else None
        if ev is None:
            from .seeds import pack_read

            process_seeds(self.view, pread, pack_read(pread), sc, res)
            return
        ev_pos, ev_diffs, ev_rank, c = ev
        replay_events(res, sc, ev_pos, ev_diffs, ev_rank, c, self.o_spec)


def _merge_tp_streams(ev: np.ndarray, cf: np.ndarray):
    """Merges the per-shard event streams of a sharded-index stage-1 call.

    ev: (2*n_shards, gcap) -- rows (2s, 2s+1) are shard s's compacted
    (pos, meta) stream; cf: (n_shards, B) count|overflow words, every
    shard covering the full unit batch.  Returns the rank-merged stream
    (pos, diffs, rank) plus per-unit (start, count, overflow).  A unit
    flagged overflow on ANY shard falls back to native re-seeding (its
    per-shard offsets may point past that shard's truncated stream)."""
    n_sh = cf.shape[0]
    B = cf.shape[1]
    cnt2d = (cf & 0x3FFFFFFF).astype(np.int64)
    ovf = ((cf >> 30) != 0).any(axis=0)
    within = np.cumsum(cnt2d, axis=1) - cnt2d
    take = np.where(ovf[None, :], 0, cnt2d)
    pos_cat, meta_cat, unit_cat = [], [], []
    for s in range(n_sh):
        c = take[s]
        total = int(c.sum())
        if total == 0:
            continue
        intra = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(c) - c, c)
        src = np.repeat(within[s], c) + intra
        pos_cat.append(ev[2 * s][src])
        meta_cat.append(ev[2 * s + 1][src])
        unit_cat.append(np.repeat(np.arange(B, dtype=np.int64), c))
    m_cnt = take.sum(axis=0)
    m_start = np.cumsum(m_cnt) - m_cnt
    if not pos_cat:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), m_start, m_cnt, ovf)
    pos_all = np.concatenate(pos_cat)
    meta_all = np.concatenate(meta_cat)
    unit_all = np.concatenate(unit_cat)
    rank_all = (meta_all & 0x3FFFFF).astype(np.int32)
    order = np.lexsort((rank_all, unit_all))
    return (pos_all[order],
            (meta_all[order] >> 22).astype(np.int32) - 512,
            rank_all[order], m_start, m_cnt, ovf)


class TpuNativeEngine:
    """Flagship engine: device stage-1 candidate generation feeding the
    native batched decide/align/format stage (_engine.cpp).

    Implements the dispatch/finish pipeline interface: the stage-1 program
    for batch k+1 is dispatched to the accelerator before batch k's events
    are collected and handed to the native library, overlapping device and
    host work.  Units whose device events overflowed (or reads longer than
    lmax) are re-seeded natively inside the library, so output stays exactly
    byte-identical to the reference at any fallback rate."""

    supports_pipeline = True
    pipeline_depth = 2  # batches in flight ahead of the native finish

    def __init__(self, index, allow_ambig=False, valid_frac=0.1,
                 pe_min_dist=32, pe_max_dist=3000, lmax: int = 128,
                 unit_batch: int = 2048, n_threads: int = 1,
                 device_put=None, mesh_devices=None, device_align=None,
                 align_jcap: int = 8192, index_shards=None,
                 device_stage2=None, device_index=None):
        from .native_engine import NativeMappingEngine

        device_backend()  # refuse an implicit CPU fallback
        if mesh_devices and index_shards:
            raise ValueError(
                "mesh_devices (data parallel) and index_shards (sharded "
                "index) are alternative mesh layouts; pick one")
        self.native = NativeMappingEngine(index, allow_ambig, valid_frac,
                                          pe_min_dist, pe_max_dist,
                                          n_threads=n_threads)
        self.lmax = lmax
        self.valid_frac = valid_frac
        self.unit_batch = unit_batch
        # stage-2 on device (fused decide+align+select; build_stage12/pe):
        # the flagship default, single-chip or data-parallel mesh (the
        # record/slot outputs shard over the data axis and the decision
        # counts psum).  The TP (sharded-index) layout still runs the
        # event-stream stage-1 path: its candidate lists span shards.
        if device_stage2 is None:
            device_stage2 = bool(int(os.environ.get(
                "ABISMAL_TPU_STAGE2", "1")))
        self.device_stage2 = bool(device_stage2) and not index_shards
        # on-device traceback for SE winners (build_tb_block): the host
        # keeps only cigar assembly + SAM text for those reads
        self.device_tb = self.device_stage2 and bool(int(os.environ.get(
            "ABISMAL_TPU_DEVTB", "1")))
        self.device_decisions = np.zeros(4, dtype=np.int64)
        self._stage12_progs = {}
        self.index_shards = 0
        if index_shards:
            # key-range-sharded index over the mesh (SURVEY 2.5 TP option):
            # position lists sharded, genome/counters replicated, unit
            # batch replicated; host merges the per-shard event streams
            from ..parallel.mesh import make_mesh, shard_stage1_tp

            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            tp_mesh = make_mesh(
                None if index_shards == "all" else int(index_shards))
            self.index_shards = int(tp_mesh.devices.size)
            tp = DeviceIndexTP(index, self.index_shards)
            self.dev = None
            self.stage1, self.o_spec = build_stage1(
                lmax, tp.max_candidates, tp.P2, tp.P3, tp=True,
                ext_iters=tp.ext_iters)
            rep = NamedSharding(tp_mesh, P())
            shd = NamedSharding(tp_mesh, P("data"))
            self._tables_tp = (
                jax.device_put(tp.genome32, rep),
                jax.device_put(overlap_rows_u32(tp.genome32), rep),
                jax.device_put(tp.counter2_np, rep),
                jax.device_put(tp.counter3_np, rep),
                jax.device_put(tp.index_local, shd),
                jax.device_put(tp.shardinfo, shd),
            )
            self._stage1_tp = shard_stage1_tp(self.stage1, tp_mesh)
        else:
            self.dev = device_index or DeviceIndex(index, device_put)
            self.stage1, self.o_spec = build_stage1(
                lmax, self.dev.max_candidates, self.dev.n_index2,
                self.dev.n_index3, ext_iters=self.dev.ext_iters)
        # host-side counter refs + lazy workload-informed candidate budget
        # for the fused stage-1+2 programs (estimate_cand_budget)
        self._host_counters = (index.counter, index.counter_t,
                               index.counter_a)
        self.cand_budget = None
        self._ext_mean = None  # oversized-bucket rate, set with the budget
        self.n_fallback = 0
        self.n_units = 0
        self._pool = None  # collector threads (created lazily)
        import threading

        self._counter_lock = threading.Lock()
        # per-stage wall-time accumulators (SURVEY §5: stage timers);
        # printed by run_map_pipelined under -v
        self.stage_time = {"unit prep": 0.0, "device dispatch": 0.0,
                           "device collect": 0.0, "native stage-2": 0.0}
        # device-side batched alignment scoring on the event-stream path:
        # the banded scorer scores all candidate hits between seed replay
        # and the native decide stage.  Off by default (the fused
        # stage-1+2 programs already score on the device; this path is
        # not measured on the GPU).
        if device_align is None:
            device_align = bool(int(os.environ.get(
                "ABISMAL_TPU_DEVICE_ALIGN", "0")))
        self.device_align = (bool(device_align) and not mesh_devices
                             and not index_shards)
        self.align_jcap = align_jcap
        self._align_prog = None
        self._unit_loc = None
        self.n_device_aligned = 0
        self.mesh = None
        self.n_shards = 1
        if mesh_devices:
            # multi-device: units sharded over the mesh's data axis, index
            # tables replicated on every device, event counts psum'd
            # (SURVEY 2.5); output stays byte-identical because shard
            # boundaries only re-pool the per-shard event budgets
            from ..parallel.mesh import (
                make_mesh, replicate_tables, shard_stage1,
            )

            self.mesh = make_mesh(
                None if mesh_devices == "all" else int(mesh_devices))
            self.n_shards = int(self.mesh.devices.size)
            if self.unit_batch % self.n_shards:
                raise ValueError("unit_batch must divide by mesh size")
            self._tables = replicate_tables(self.dev, self.mesh)
            self._stage1_sharded = shard_stage1(self.stage1, self.mesh)

    def _stage1_call(self, preads, lens, is_ga, thr):
        if self.index_shards:
            # sharded-index streams: ev rows (2s, 2s+1) per shard, cf is
            # (n_shards, B) -- every shard covers the full unit batch
            return self._stage1_tp(*self._tables_tp, preads, lens, is_ga,
                                   thr)
        if self.mesh is None:
            return self.stage1(*self.dev.tables(), preads, lens, is_ga, thr)
        ev, cf, _total = self._stage1_sharded(
            self._tables, preads, lens, is_ga, thr)
        return ev, cf

    def preferred_read_batch(self, paired, random_pbat):
        """Reads per batch such that one batch fills one stage-1 device
        call (unit_batch units), amortizing the per-call cost."""
        per = (8 if random_pbat else 4) if paired else \
              (4 if random_pbat else 2)
        return max(250, self.unit_batch // per)

    @property
    def n_threads(self):
        return self.native.n_threads

    @n_threads.setter
    def n_threads(self, v):
        self.native.n_threads = max(1, v)

    @property
    def n_device_mated(self):
        """Orientations decided by the device-resident mating sweep."""
        return self.native.n_device_mated

    # --- flat unit enumeration (canonical ids shared with _engine.cpp) ----
    def _se_units_flat(self, reads, a_rich_mode, random_pbat):
        from ..utils.dna import revcomp_str

        units = []
        per = 4 if random_pbat else 2
        for ri, (_, read) in enumerate(reads):
            if not read:
                continue
            if not random_pbat:
                conv = a_rich_mode
                units.append((2 * ri, prep_read(read, conv),
                              get_conv_is_ga(strand_code("+", conv))))
                rc = revcomp_str(read.decode()).encode()
                units.append((2 * ri + 1, prep_read(rc, not conv),
                              get_conv_is_ga(strand_code("-", conv))))
            else:
                rc = revcomp_str(read.decode()).encode()
                units.append((4 * ri, prep_read(read, False),
                              get_conv_is_ga(strand_code("+", False))))
                units.append((4 * ri + 1, prep_read(read, True),
                              get_conv_is_ga(strand_code("+", True))))
                units.append((4 * ri + 2, prep_read(rc, False),
                              get_conv_is_ga(strand_code("-", True))))
                units.append((4 * ri + 3, prep_read(rc, True),
                              get_conv_is_ga(strand_code("-", False))))
        return units, per * len(reads)

    def _pe_units_flat(self, reads1, reads2, a_rich_mode, random_pbat):
        from ..utils.dna import revcomp_str

        units = []
        per = 8 if random_pbat else 4
        convs = [a_rich_mode] if not random_pbat else [False, True]

        for ri, ((_, r1), (_, r2)) in enumerate(zip(reads1, reads2)):
            uid = per * ri
            for conv in convs:
                if r1:
                    units.append((uid, prep_read(r1, conv),
                                  get_conv_is_ga(strand_code("+", conv))))
                if r2:
                    rc2 = revcomp_str(r2.decode()).encode()
                    units.append((uid + 1, prep_read(rc2, conv),
                                  get_conv_is_ga(strand_code("-", not conv))))
                    units.append((uid + 2, prep_read(r2, not conv),
                                  get_conv_is_ga(strand_code("+", not conv))))
                if r1:
                    rc1 = revcomp_str(r1.decode()).encode()
                    units.append((uid + 3, prep_read(rc1, not conv),
                                  get_conv_is_ga(strand_code("-", conv))))
                uid += 4
        return units, per * len(reads1)

    # --- stage-1 dispatch (shared with TpuMappingEngine) -------------------
    _dispatch_units = TpuMappingEngine._dispatch_units

    def _collect_flat(self, dispatched, n_units):
        """Pulls dispatched device results into the native engine's flat
        event-stream format: (pos u32, diffs i32, rank i32, start i64,
        count i64, boundary).  count < 0 routes the unit to native
        re-seeding.  Returns (events, unit_loc); called from the collector
        thread pool, so per-batch state is returned, not stored, and the
        shared counters are guarded."""
        pre_cache, pending = dispatched
        start = np.zeros(n_units, dtype=np.int64)
        count = np.full(n_units, -1, dtype=np.int64)
        # unit -> (chunk, device row) mapping for the device align program
        unit_chunk = np.full(n_units, -1, dtype=np.int32)
        unit_row = np.zeros(n_units, dtype=np.int32)
        pos_parts, diff_parts, rank_parts = [], [], []
        base = 0
        for ci, (chunk, (ev_dev, cf_dev), _pn) in enumerate(pending):
            ev = np.asarray(ev_dev)
            cf = np.asarray(cf_dev)
            if self.index_shards:
                # sharded-index mode: every shard emitted events for ALL
                # units; merge the per-shard streams by rank (exact: each
                # bucket lives on one shard, so rank order == the unsharded
                # discovery order)
                m_pos, m_diff, m_rank, m_start, m_cnt, m_ovf = \
                    _merge_tp_streams(ev, cf)
                pos_parts.append(m_pos)
                diff_parts.append(m_diff)
                rank_parts.append(m_rank)
                n_fb = 0
                for i, u in enumerate(chunk):
                    unit_chunk[u[0]] = ci
                    unit_row[u[0]] = i
                    if m_ovf[i]:
                        n_fb += 1
                    else:
                        start[u[0]] = base + m_start[i]
                        count[u[0]] = m_cnt[i]
                with self._counter_lock:
                    self.n_units += len(chunk)
                    self.n_fallback += n_fb
                base += int(m_pos.shape[0])
                continue
            cnt = (cf & 0x3FFFFFFF).astype(np.int64)
            overflow = (cf >> 30) != 0
            # sharded results stack each shard's (pos, meta) rows along
            # axis 0: shard s owns rows (2s, 2s+1) with its own compacted
            # stream; per-unit offsets restart at each shard boundary
            n_sh = ev.shape[0] // 2
            b_local = cnt.shape[0] // n_sh
            cnt2d = cnt.reshape(n_sh, b_local)
            within = np.cumsum(cnt2d, axis=1) - cnt2d
            # clamp to the stream capacity: when a shard's accepted events
            # exceed gcap the device truncates the stream (and flags every
            # affected unit overflow); the offset bookkeeping must use the
            # written length, not the accepted count, or every later shard
            # and chunk decodes shifted garbage
            gcap = ev.shape[1]
            totals = np.minimum(within[:, -1] + cnt2d[:, -1], gcap)
            shard_base = np.concatenate(([0], np.cumsum(totals)))[:-1]
            unit_start_flat = (shard_base[:, None] + within).reshape(-1)
            for s in range(n_sh):
                t = int(totals[s])
                gpos, gmeta = ev[2 * s], ev[2 * s + 1]
                pos_parts.append(gpos[:t])
                diff_parts.append((gmeta[:t] >> 22).astype(np.int32) - 512)
                rank_parts.append((gmeta[:t] & 0x3FFFFF).astype(np.int32))
            total = int(totals.sum())
            n_fb = 0
            for i, u in enumerate(chunk):
                unit_chunk[u[0]] = ci
                unit_row[u[0]] = i
                if overflow[i]:
                    n_fb += 1
                else:
                    start[u[0]] = base + unit_start_flat[i]
                    count[u[0]] = cnt[i]
            with self._counter_lock:
                self.n_units += len(chunk)
                self.n_fallback += n_fb
            base += total
        with self._counter_lock:
            self.n_units += len(pre_cache)
            self.n_fallback += len(pre_cache)
        if pos_parts:
            ev_pos = np.ascontiguousarray(np.concatenate(pos_parts))
            ev_diffs = np.ascontiguousarray(np.concatenate(diff_parts))
            ev_rank = np.ascontiguousarray(np.concatenate(rank_parts))
        else:
            ev_pos = np.zeros(1, dtype=np.uint32)
            ev_diffs = np.zeros(1, dtype=np.int32)
            ev_rank = np.zeros(1, dtype=np.int32)
        boundary = self.o_spec * 2 * SLOT
        return (ev_pos, ev_diffs, ev_rank, start, count, boundary), \
            (unit_chunk, unit_row)

    def _submit_collect(self, disp, n_units):
        """Starts the device->host sync on the collector pool, so batch
        k+1's results stream in while batch k is in the native stage."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.pipeline_depth)
        return self._pool.submit(self._collect_flat, disp, n_units)

    def _budget_for(self, units, is_ga_pat, per):
        """Workload-informed candidate budget, measured once on the first
        batch's units (estimate_cand_budget).  units: a list of per-unit
        nibble arrays, or a (pnib, lens_u) packed matrix pair from
        _se_units_mat."""
        if self.cand_budget is None:
            if isinstance(units, tuple):
                pnib, lens_u = units
                unp = np.empty((pnib.shape[0], 2 * pnib.shape[1]), np.uint8)
                unp[:, 0::2] = pnib & np.uint8(0xF)
                unp[:, 1::2] = pnib >> np.uint8(4)
                units = [unp[i, : lens_u[i]] for i in range(pnib.shape[0])]
            is_ga = [bool(is_ga_pat[i % per]) for i in range(len(units))]
            self.cand_budget, self._ext_mean = estimate_cand_budget(
                self._host_counters, self.dev.max_candidates, units, is_ga,
                self.lmax)
        return self.cand_budget

    def _informed_ext_pool(self):
        """Extension-pool size from the measured oversized-bucket rate
        (estimate_cand_budget): demand is ~0.01 lanes/unit at a 1 GB
        index vs the 512-lane static default, and every bisection trip
        costs probe lanes proportional to the pool.  Margin is
        statistical, not a flat multiple: chunk demand d is a sum of
        ~independent per-unit events, so its spread is ~sqrt(d) --
        8 sigma covers batch-to-batch noise, and the 2x term covers
        systematic drift past the first-chunk measurement.  At SE-scale
        demand (~10/chunk) this lands on the same 128-lane pool as the
        old flat 6x; at PE-scale demand (A-rich mates measure ~10x the
        oversized-bucket rate, ~210/chunk) it halves the pool the 6x
        rule picked, and every bisection trip pays for each probe lane.
        Spills set ext_fb (exact host remap), never wrong output.
        None = static default (no measurement)."""
        em = getattr(self, "_ext_mean", None)
        if em is None:
            return None
        d = em * self.unit_batch
        want = max(d + 8.0 * d ** 0.5, 2.0 * d)
        return int(np.clip((int(want) + 127) & ~63, 128, 4096))

    # --- fused stage-1+2 path (SE): one record per read --------------------
    def _stage12_prog(self, per, cand_budget=None):
        ext_pool = self._informed_ext_pool()
        key = (per, cand_budget, ext_pool)
        prog = self._stage12_progs.get(key)
        if prog is None:
            prog, _ = build_stage12(self.lmax, self.dev.max_candidates,
                                    self.dev.n_index2, self.dev.n_index3,
                                    per, cand_per_unit=cand_budget,
                                    interpret=interpret_kernels(),
                                    ext_iters=self.dev.ext_iters,
                                    device_tb=self.device_tb,
                                    ext_pool=ext_pool)
            if self.mesh is not None:
                from ..parallel.mesh import shard_stage12

                prog = shard_stage12(prog, self.mesh)
            self._stage12_progs[key] = prog
        return prog

    def _stage12pe_prog(self, per, cand_budget=None):
        ext_pool = self._informed_ext_pool()
        key = ("pe", per, cand_budget, ext_pool)
        prog = self._stage12_progs.get(key)
        if prog is None:
            prog, _ = build_stage12pe(self.lmax, self.dev.max_candidates,
                                      self.dev.n_index2, self.dev.n_index3,
                                      per=per, cand_per_unit=cand_budget,
                                      interpret=interpret_kernels(),
                                      ext_iters=self.dev.ext_iters,
                                      ext_pool=ext_pool)
            if self.mesh is not None:
                from ..parallel.mesh import shard_stage12pe

                prog = shard_stage12pe(prog, self.mesh)
            self._stage12_progs[key] = prog
        return prog

    @staticmethod
    def _se_scode_pattern(a_rich_mode, random_pbat):
        if not random_pbat:
            return np.array([strand_code("+", a_rich_mode),
                             strand_code("-", a_rich_mode)], dtype=np.int32)
        # RPBAT unit order matches _se_units_flat: (fw,T), (fw,A),
        # (rc as T-rich, strand code a-rich), (rc as A-rich, strand code
        # T-rich) -- the encoding and the reported conversion cross over
        # on the reverse strand (abismal.cpp:1602-1704)
        return np.array([strand_code("+", False), strand_code("+", True),
                         strand_code("-", True), strand_code("-", False)],
                        dtype=np.int32)

    def _se_units_dense(self, reads, a_rich_mode, random_pbat):
        """Dense layout for build_stage12: every read occupies exactly
        `per` consecutive unit rows; empty and oversized reads upload
        zero-length rows (oversized ones are forced to REC_FALLBACK on
        collection)."""
        from ..utils.dna import revcomp_str

        per = 4 if random_pbat else 2
        units = []
        oversized = np.zeros(len(reads), dtype=bool)
        empty_row = np.zeros(0, dtype=np.uint8)
        for ri, (_, read) in enumerate(reads):
            if not read or len(read) > self.lmax:
                oversized[ri] = bool(read) and len(read) > self.lmax
                units.extend([empty_row] * per)
                continue
            rc = revcomp_str(read.decode()).encode()
            if not random_pbat:
                units.append(prep_read(read, a_rich_mode))
                units.append(prep_read(rc, not a_rich_mode))
            else:
                units.append(prep_read(read, False))
                units.append(prep_read(read, True))
                units.append(prep_read(rc, False))
                units.append(prep_read(rc, True))
        return units, per, oversized

    @staticmethod
    def _ascii_matrices(seqs, lmax):
        """(R, lmax) u8 ASCII matrix, its row-wise reverse complement,
        and per-read lengths, from a list of byte strings.  Callers must
        pre-blank oversized entries (b""); byte-level ljust joins beat
        NumPy scatter layouts ~6x here.  REVCOMP_TABLE maps \\0 -> 'N',
        so the reversed matrix's padding is re-zeroed from the forward
        matrix's zero columns cheaply."""
        from ..utils.dna import REVCOMP_TABLE

        R = len(seqs)
        lens = np.fromiter((len(s) if s else 0 for s in seqs),
                           dtype=np.int64, count=R)
        pad = b"\x00" * lmax
        A = np.frombuffer(
            b"".join((s or pad).ljust(lmax, b"\x00") for s in seqs)
            or pad, dtype=np.uint8).reshape(max(R, 1), lmax)
        Arc = REVCOMP_TABLE[np.frombuffer(
            b"".join((s[::-1] or pad).ljust(lmax, b"\x00") for s in seqs)
            or pad, dtype=np.uint8).reshape(max(R, 1), lmax)]
        Arc[A == 0] = 0
        return A, Arc, lens

    def _se_units_mat(self, reads, a_rich_mode, random_pbat):
        """Vectorized _se_units_dense: returns (pnib, lens_u, per,
        oversized) with the read-ASCII -> encoded-unit -> packed-nibble
        pipeline done in whole-batch NumPy ops (the per-read Python loop
        cost ~8 us/read, more than the whole native engine's budget)."""
        from ..utils.dna import ENCODE_A_RICH, ENCODE_T_RICH

        per = 4 if random_pbat else 2
        R = len(reads)
        seqs = [s for _, s in reads]
        oversized = np.fromiter(
            (bool(s) and len(s) > self.lmax for s in seqs),
            dtype=bool, count=R)
        if oversized.any():
            seqs = [b"" if o else s for s, o in zip(seqs, oversized)]
        A, Arc, L = self._ascii_matrices(seqs, self.lmax)
        W = self.lmax + 32  # upload guard columns (prepare_units layout)
        B = per * max(R, 1)
        U = np.zeros((B, W), np.uint8)
        if not random_pbat:
            ef, er = ((ENCODE_A_RICH, ENCODE_T_RICH) if a_rich_mode
                      else (ENCODE_T_RICH, ENCODE_A_RICH))
            U[0::2, : self.lmax] = ef[A]
            U[1::2, : self.lmax] = er[Arc]
        else:
            U[0::4, : self.lmax] = ENCODE_T_RICH[A]
            U[1::4, : self.lmax] = ENCODE_A_RICH[A]
            U[2::4, : self.lmax] = ENCODE_T_RICH[Arc]
            U[3::4, : self.lmax] = ENCODE_A_RICH[Arc]
        # encoding tables map \0 to 0, so zero-padded tails stay zero
        pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
        lens_u = np.repeat(L, per).astype(np.int32)
        return pnib, lens_u, per, oversized

    def _pe_units_dense(self, reads1, reads2, a_rich_mode, random_pbat):
        """Dense PE layout for build_stage12pe: every pair occupies
        exactly `per` consecutive unit rows in _pe_units_flat order
        (native map_one_pe's unit-id enumeration); pairs with an
        oversized end upload zero-length rows and are forced to native
        seeding on collection."""
        from ..utils.dna import revcomp_str

        per = 8 if random_pbat else 4
        convs = [a_rich_mode] if not random_pbat else [False, True]
        units = []
        oversized = np.zeros(len(reads1), dtype=bool)
        empty_row = np.zeros(0, dtype=np.uint8)
        for ri, ((_, r1), (_, r2)) in enumerate(zip(reads1, reads2)):
            if (r1 and len(r1) > self.lmax) or (r2 and len(r2) > self.lmax):
                oversized[ri] = True
                units.extend([empty_row] * per)
                continue
            rc1 = revcomp_str(r1.decode()).encode() if r1 else b""
            rc2 = revcomp_str(r2.decode()).encode() if r2 else b""
            for conv in convs:
                units.append(prep_read(r1, conv) if r1 else empty_row)
                units.append(prep_read(rc2, conv) if r2 else empty_row)
                units.append(prep_read(r2, not conv) if r2 else empty_row)
                units.append(prep_read(rc1, not conv) if r1 else empty_row)
        return units, per, oversized

    def _pe_units_mat(self, reads1, reads2, a_rich_mode, random_pbat):
        """Vectorized _pe_units_dense: (pnib, lens_u, per, oversized)
        in the _pe_units_flat row order, whole-batch NumPy."""
        from ..utils.dna import ENCODE_A_RICH, ENCODE_T_RICH

        per = 8 if random_pbat else 4
        R = len(reads1)
        s1 = [s for _, s in reads1]
        s2 = [s for _, s in reads2]
        oversized = np.fromiter(
            ((bool(a) and len(a) > self.lmax)
             or (bool(b) and len(b) > self.lmax)
             for a, b in zip(s1, s2)), dtype=bool, count=R)
        if oversized.any():
            s1 = [b"" if o else s for s, o in zip(s1, oversized)]
            s2 = [b"" if o else s for s, o in zip(s2, oversized)]
        A1, Arc1, L1 = self._ascii_matrices(s1, self.lmax)
        A2, Arc2, L2 = self._ascii_matrices(s2, self.lmax)
        W = self.lmax + 32
        B = per * max(R, 1)
        U = np.zeros((B, W), np.uint8)
        convs = [a_rich_mode] if not random_pbat else [False, True]
        for ci, conv in enumerate(convs):
            e1, e2 = ((ENCODE_A_RICH, ENCODE_T_RICH) if conv
                      else (ENCODE_T_RICH, ENCODE_A_RICH))
            o = 4 * ci
            U[o + 0 :: per, : self.lmax] = e1[A1]
            U[o + 1 :: per, : self.lmax] = e1[Arc2]
            U[o + 2 :: per, : self.lmax] = e2[A2]
            U[o + 3 :: per, : self.lmax] = e2[Arc1]
        pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
        lens_u = np.zeros(B, np.int32)
        for ci in range(len(convs)):
            o = 4 * ci
            lens_u[o + 0 :: per] = L1
            lens_u[o + 1 :: per] = L2
            lens_u[o + 2 :: per] = L2
            lens_u[o + 3 :: per] = L1
        return pnib, lens_u, per, oversized

    @staticmethod
    def _pe_is_ga_pattern(a_rich_mode, random_pbat):
        """Per-unit conversion (G->A table?) flags in _pe_units_flat
        order."""
        convs = [a_rich_mode] if not random_pbat else [False, True]
        pat = []
        for conv in convs:
            pat += [get_conv_is_ga(strand_code("+", conv)),
                    get_conv_is_ga(strand_code("-", not conv)),
                    get_conv_is_ga(strand_code("+", not conv)),
                    get_conv_is_ga(strand_code("-", conv))]
        return np.array(pat, dtype=bool)

    def _dispatch_se_stage12(self, reads, a_rich_mode, random_pbat):
        pnib_all, lens_all, per, oversized = self._se_units_mat(
            reads, a_rich_mode, random_pbat)
        scode_pat = self._se_scode_pattern(a_rich_mode, random_pbat)
        is_ga_pat = np.array([get_conv_is_ga(int(c)) for c in scode_pat],
                             dtype=bool)
        prog = self._stage12_prog(
            per, self._budget_for((pnib_all, lens_all), is_ga_pat, per))
        q = per * self.n_shards  # batch quantum (units/read x mesh axis)
        B = max(q, self.unit_batch - (self.unit_batch % q))
        rpc = B // per  # reads per chunk
        pending = []
        for start in range(0, len(reads), rpc):
            n = min(rpc, len(reads) - start)
            nu = n * per
            preads = pnib_all[start * per : start * per + nu]
            lens = lens_all[start * per : start * per + nu]
            pad = B - nu
            if pad:
                preads = np.pad(preads, ((0, pad), (0, 0)))
                lens = np.pad(lens, (0, pad))
            lens_r = lens.reshape(rpc, per).max(axis=1)
            # int(valid_frac * len): float64 multiply then truncation
            # toward zero, matching the C cast (diffs_cutoff)
            max_diffs_r = (self.valid_frac
                           * lens_r.astype(np.float64)).astype(np.int32)
            is_ga = np.tile(is_ga_pat, rpc)
            if self.mesh is not None:
                rec, counts = prog(self._tables, preads, lens, is_ga,
                                   scode_pat, max_diffs_r)
            else:
                rec = prog(*self.dev.tables(), preads, lens, is_ga,
                           scode_pat, max_diffs_r)
                counts = None
            try:
                rec.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
            pending.append((start, n, rec, counts))
        return (reads, a_rich_mode, random_pbat, per, pending, oversized)

    def _finish_se_stage12(self, handle, stats, out):
        reads, arm, rp, per, pending, oversized = handle
        t1 = time.perf_counter()
        R = len(reads)
        W = 8 + TB_NOPS if self.device_tb else 4
        packed = np.zeros((max(R, 1), W), dtype=np.int32)
        if self.device_tb:
            packed[:, 4] = -1  # meta n_ops sentinel for padded rows
        for start, n, rec, counts in pending:
            packed[start : start + n] = np.asarray(rec)[:n]
            if counts is not None:
                # psum'd per-status decision counts from the mesh; padded
                # reads land in status 0 (unmapped), subtract them
                c = np.asarray(counts).astype(np.int64)
                c[0] -= np.asarray(rec).shape[0] - n
                with self._counter_lock:
                    self.device_decisions += c
        records = packed[:, :4]
        cig_ops = cig_meta = None
        if self.device_tb:
            cig_meta = np.ascontiguousarray(packed[:, 4:8])
            cig_ops = np.ascontiguousarray(packed[:, 8:])
        idx = np.flatnonzero(oversized)
        if idx.size:
            records[idx] = np.array([REC_FALLBACK, 0, 0, 0], dtype=np.int32)
        n_fb = int(((records[:R, 0] & 7) == REC_FALLBACK).sum())
        with self._counter_lock:
            self.n_units += R * per
            self.n_fallback += n_fb * per
        t2 = time.perf_counter()
        self.stage_time["device collect"] += t2 - t1
        self.native._finalize_se(
            reads, arm, rp, records[:R], stats, out,
            cig_ops=None if cig_ops is None else cig_ops[:R],
            cig_meta=None if cig_meta is None else cig_meta[:R])
        self.stage_time["native stage-2"] += time.perf_counter() - t2
        return R

    def _dispatch_pe_stage12(self, reads1, reads2, a_rich_mode,
                             random_pbat):
        pnib_all, lens_all, per, oversized = self._pe_units_mat(
            reads1, reads2, a_rich_mode, random_pbat)
        is_ga_pat = self._pe_is_ga_pattern(a_rich_mode, random_pbat)
        prog = self._stage12pe_prog(
            per, self._budget_for((pnib_all, lens_all), is_ga_pat, per))
        pe_dist = np.array([self.native.pe_min_dist, self.native.pe_max_dist],
                           dtype=np.int32)
        q = per * self.n_shards
        B = max(q, self.unit_batch - (self.unit_batch % q))
        ppc = B // per  # pairs per chunk
        pending = []
        for start in range(0, len(reads1), ppc):
            n = min(ppc, len(reads1) - start) * per
            preads = pnib_all[start * per : start * per + n]
            lens = lens_all[start * per : start * per + n]
            pad = B - n
            if pad:
                preads = np.pad(preads, ((0, pad), (0, 0)))
                lens = np.pad(lens, (0, pad))
            # int(valid_frac * len) per UNIT (PE ends differ in length)
            max_diffs_u = (self.valid_frac
                           * lens.astype(np.float64)).astype(np.int32)
            is_ga = np.tile(is_ga_pat, B // per)
            if self.mesh is not None:
                pk, _fb = prog(self._tables, preads, lens, is_ga,
                               max_diffs_u, pe_dist)
            else:
                pk = prog(*self.dev.tables(), preads, lens, is_ga,
                          max_diffs_u, pe_dist)
            try:
                pk.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
            pending.append((start, n, pk))
        return (reads1, reads2, a_rich_mode, random_pbat, per, pending,
                oversized)

    def _finish_pe_stage12(self, handle, stats, out):
        reads1, reads2, arm, rp, per, pending, oversized = handle
        t1 = time.perf_counter()
        n_units = per * len(reads1)
        n_pairs = len(reads1)
        K = 32
        O10 = (per // 2) * 10
        packed = np.zeros((max(n_units, 1), 2 * K + 6), dtype=np.int32)
        packed[:, 2 * K] = -1  # cnt sentinel for rows with no chunk
        for start, n, pk in pending:
            s = start * per
            packed[s : s + n] = np.asarray(pk)[:n]
        pos_all = np.ascontiguousarray(packed[:, :K]).view(np.uint32)
        ds_all = np.ascontiguousarray(packed[:, K : 2 * K])
        cnt_all = np.ascontiguousarray(packed[:, 2 * K])
        mate_all = np.zeros((max(n_pairs, 1), O10), dtype=np.int32)
        if n_pairs:
            mate_all[:] = packed[: n_pairs * per, 2 * K + 1 :].reshape(
                n_pairs, O10)
        idx = np.flatnonzero(oversized)
        for ri in idx:
            cnt_all[ri * per : (ri + 1) * per] = -1
        n_fb = int((cnt_all[:n_units] < 0).sum())
        with self._counter_lock:
            self.n_units += n_units
            self.n_fallback += n_fb
        t2 = time.perf_counter()
        self.stage_time["device collect"] += t2 - t1
        # The device sweep is live under -a (allow-ambig) too: ambiguous
        # pairs ARE reported there, so the winner's identity matters for
        # every pair -- but the only place the reference's mid-sweep
        # sure-ambig truncation (abismal.cpp:1722-1831) can change the
        # winner is a max-score tie with differing diff-sums, which the
        # device flags in mate slot 9 and the host then replays with the
        # exact injected-score sequential sweep (see build_stage12pe's
        # fbm notes).  Below max score no truncation happens, so the
        # device argmax equals the reference's final state.
        self.native._call_pe_slots(reads1, reads2, arm, rp, stats, out,
                                   pos_all[:n_units], ds_all[:n_units],
                                   cnt_all[:n_units], mate_all[:n_pairs])
        self.stage_time["native stage-2"] += time.perf_counter() - t2
        return len(reads1)

    # --- pipeline interface -------------------------------------------------
    def dispatch_se(self, reads, a_rich_mode, random_pbat):
        t0 = time.perf_counter()
        if self.device_stage2:
            h = self._dispatch_se_stage12(reads, a_rich_mode, random_pbat)
            self.stage_time["device dispatch"] += time.perf_counter() - t0
            return ("s2",) + h
        units, n_units = self._se_units_flat(reads, a_rich_mode, random_pbat)
        t1 = time.perf_counter()
        disp = self._dispatch_units(units)
        fut = self._submit_collect(disp, n_units)
        t2 = time.perf_counter()
        self.stage_time["unit prep"] += t1 - t0
        self.stage_time["device dispatch"] += t2 - t1
        return (reads, a_rich_mode, random_pbat, n_units, disp, fut)

    def finish_se(self, handle, stats, out):
        if handle[0] == "s2":
            return self._finish_se_stage12(handle[1:], stats, out)
        reads, arm, rp, n_units, disp, fut = handle
        t0 = time.perf_counter()
        events, self._unit_loc = fut.result()
        t1 = time.perf_counter()
        self.stage_time["device collect"] += t1 - t0
        if not self.device_align:
            self.native._call_se(reads, arm, rp, stats, out, events)
            self.stage_time["native stage-2"] += time.perf_counter() - t1
            return len(reads)
        n_jobs, jobs = self.native._phase1_se(reads, arm, rp, events)
        scores = np.full(n_jobs, np.iinfo(np.int32).min, dtype=np.int32)
        if n_jobs:
            # jobs[:, 1] is the encoding selector (pt, pt_rc, pa, pa_rc);
            # map it to the unit-id offset of _se_units_flat
            r, enc = jobs[:, 0], jobs[:, 1]
            per = 4 if rp else 2
            if rp:
                uoff = np.array([0, 2, 1, 3], dtype=np.int32)[enc]
            else:
                uoff = ((enc == 1) | (enc == 3)).astype(np.int32)
            self._score_jobs_on_device(jobs, scores, per * r + uoff,
                                       disp[1])
        self.native._phase2_se(scores, stats, out)
        self.stage_time["native stage-2"] += time.perf_counter() - t1
        return len(reads)

    def _score_jobs_on_device(self, jobs, scores, uid, pending):
        """Scores alignment jobs with the banded scorer, reusing the
        stage-1 unit matrices already resident on the device.  uid maps each
        job to its flat unit id (the device row holding the query).  Jobs
        whose queries are not resident (oversized reads) or beyond the
        per-chunk job cap keep the sentinel and are scored natively in
        phase 2."""
        from ..kernels.banded_align import build_device_align

        if self._align_prog is None:
            self._align_prog = build_device_align(
                self.lmax, interpret=interpret_kernels())
        uc, ur = self._unit_loc
        cidx = uc[uid]
        row = ur[uid]
        jcap = self.align_jcap
        for ci, (_chunk, _outs, pn) in enumerate(pending):
            sel = np.flatnonzero(cidx == ci)
            if sel.size == 0:
                continue
            take = sel[:jcap]
            unit_id = np.zeros(jcap, dtype=np.int32)
            pos = np.full(jcap, 32767, dtype=np.uint32)  # padding-safe
            bw = np.ones(jcap, dtype=np.int32)
            qsz = np.zeros(jcap, dtype=np.int32)
            n = take.shape[0]
            unit_id[:n] = row[take]
            pos[:n] = jobs[take, 2].astype(np.int64) & 0xFFFFFFFF
            bw[:n] = jobs[take, 3]
            qsz[:n] = jobs[take, 4]
            res = np.asarray(self._align_prog(
                self.dev.genome32, pn, unit_id, pos, bw, qsz))
            scores[take] = res[:n]
            self.n_device_aligned += int(n)

    def dispatch_pe(self, reads1, reads2, a_rich_mode, random_pbat):
        t0 = time.perf_counter()
        if self.device_stage2:
            h = self._dispatch_pe_stage12(reads1, reads2, a_rich_mode,
                                          random_pbat)
            self.stage_time["device dispatch"] += time.perf_counter() - t0
            return ("s2",) + h
        units, n_units = self._pe_units_flat(reads1, reads2, a_rich_mode,
                                             random_pbat)
        t1 = time.perf_counter()
        disp = self._dispatch_units(units)
        fut = self._submit_collect(disp, n_units)
        t2 = time.perf_counter()
        self.stage_time["unit prep"] += t1 - t0
        self.stage_time["device dispatch"] += t2 - t1
        return (reads1, reads2, a_rich_mode, random_pbat, n_units, disp, fut)

    def finish_pe(self, handle, stats, out):
        if handle[0] == "s2":
            return self._finish_pe_stage12(handle[1:], stats, out)
        reads1, reads2, arm, rp, n_units, disp, fut = handle
        t0 = time.perf_counter()
        events, self._unit_loc = fut.result()
        t1 = time.perf_counter()
        self.stage_time["device collect"] += t1 - t0
        if not self.device_align:
            self.native._call_pe(reads1, reads2, arm, rp, stats, out, events)
            self.stage_time["native stage-2"] += time.perf_counter() - t1
            return len(reads1)
        n_jobs, jobs = self.native._phase1_pe(reads1, reads2, arm, rp,
                                              events)
        scores = np.full(n_jobs, np.iinfo(np.int32).min, dtype=np.int32)
        if n_jobs:
            # jobs[:, 1] is the worker buffer slot, which equals the
            # unit-id offset of _pe_units_flat by construction
            per = 8 if rp else 4
            uid = per * jobs[:, 0] + jobs[:, 1]
            self._score_jobs_on_device(jobs, scores, uid, disp[1])
        self.native._phase2_pe(scores, stats, out)
        self.stage_time["native stage-2"] += time.perf_counter() - t1
        return len(reads1)

    # --- MappingEngine-compatible entry points ------------------------------
    def map_se_reads(self, reads, a_rich_mode, random_pbat, stats, out):
        self.finish_se(self.dispatch_se(reads, a_rich_mode, random_pbat),
                       stats, out)

    def map_pe_reads(self, reads1, reads2, a_rich_mode, random_pbat, stats,
                     out):
        self.finish_pe(
            self.dispatch_pe(reads1, reads2, a_rich_mode, random_pbat),
            stats, out)


_engine_memo = {}


def make_native_engine_factory(n_threads: int = 1):
    """Pure-native engine: C++ seeding + decide/align/format, no device."""

    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        from .native_engine import NativeMappingEngine

        return NativeMappingEngine(index, allow_ambig, valid_frac,
                                   pe_min_dist, pe_max_dist,
                                   n_threads=n_threads)

    factory.is_native = True
    return factory


def make_tpu_native_engine_factory(lmax: int = 128, unit_batch: int = 2048,
                                   n_threads: int = 1, mesh_devices=None,
                                   device_align=None, align_jcap: int = 8192,
                                   index_shards=None, device_stage2=None):
    """Flagship: device stage-1 + native stage-2, memoized per index.
    mesh_devices="all" (or an int) shards unit batches over the local
    device mesh with the index replicated per chip; index_shards="all"
    (or an int) instead shards the index position lists by key range
    (TP option) with the unit batch replicated.  device_align=True
    scores candidate alignments on the device too (None = env default)."""

    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        key = ("tpu-native", id(index), int(index.max_candidates),
               allow_ambig, valid_frac, pe_min_dist, pe_max_dist, lmax,
               unit_batch, mesh_devices, device_align, align_jcap,
               index_shards, device_stage2)
        hit = _engine_memo.get(key)
        if hit is not None and hit[0] is index:
            hit[1].n_threads = n_threads
            return hit[1]
        eng = TpuNativeEngine(index, allow_ambig, valid_frac, pe_min_dist,
                              pe_max_dist, lmax=lmax, unit_batch=unit_batch,
                              n_threads=n_threads, mesh_devices=mesh_devices,
                              device_align=device_align,
                              align_jcap=align_jcap,
                              index_shards=index_shards,
                              device_stage2=device_stage2)
        _engine_memo[key] = (index, eng)
        return eng

    factory.is_native = True
    return factory


def make_tpu_engine_factory(lmax: int = 128, unit_batch: int = 1024):
    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        # engine construction uploads ~700 MB of index tables; reuse the
        # engine across run_map calls for the same index/parameters.  The
        # memo value pins the index object so a dead index's id() can never
        # be reused by a different index and alias the old device tables.
        key = (id(index), int(index.max_candidates), allow_ambig, valid_frac,
               pe_min_dist, pe_max_dist, lmax, unit_batch)
        hit = _engine_memo.get(key)
        if hit is not None and hit[0] is index:
            return hit[1]
        eng = TpuMappingEngine(index, allow_ambig, valid_frac,
                               pe_min_dist, pe_max_dist, lmax=lmax,
                               unit_batch=unit_batch)
        _engine_memo[key] = (index, eng)
        return eng

    factory.is_tpu = True
    return factory


def prepare_units(unit_reads, lmax: int):
    """Host-side layout of encoded unit reads (list of uint8 nibble arrays)
    into the fixed-shape stage-1 inputs: two nibbles per uploaded byte
    (half-size transfers); unpacking and word packing happen on device."""
    B = len(unit_reads)
    preads = np.zeros((B, lmax + 32), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, pr in enumerate(unit_reads):
        n = pr.shape[0]
        lens[i] = n
        preads[i, :n] = pr
    pnib = preads[:, 0::2] | (preads[:, 1::2] << np.uint8(4))
    return pnib, lens


class EventReplayEngine(MappingEngine):
    """Worker-side engine: replays externally supplied event caches (no
    device access).  Used by the hybrid runner, where the parent process
    drives the accelerator and forked workers do the sequential decide/
    align/format work."""

    def __init__(self, *args, **kwargs):
        MappingEngine.__init__(self, *args, **kwargs)
        self._cache = {}
        self.o_spec = o_spec_for(128)

    def set_cache(self, cache, o_spec):
        self._cache = cache
        self.o_spec = o_spec

    def _seeds(self, pread, sc, res, key=None):
        ev = self._cache.get(key, None) if key is not None else None
        if ev is None:
            from .seeds import pack_read

            process_seeds(self.view, pread, pack_read(pread), sc, res)
            return
        ev_pos, ev_diffs, ev_rank, c = ev
        replay_events(res, sc, ev_pos, ev_diffs, ev_rank, c, self.o_spec)
