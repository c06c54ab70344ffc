"""Batched banded local-alignment scoring and traceback on the device.

Computes the reference's AbismalAlign score (src/AbismalAlign.hpp:320-386)
for a batch of (query, genome-window, bandwidth) jobs: int-exact scores,
zero floor, per-job band narrowing and the in-row insertion chain.  The
tracer variant also stores every cell's traceback arrow
(AbismalAlign.hpp:266-307) for the device traceback walk.

Row reparametrization: rows are r = i - b (i the reference's table row, b
the per-job band width), which makes the diagonal move's query index
qi = r + c independent of b.  The query sits at ONE fixed offset
(QOFF = BW_MAX - 1) for every job, so callers never shift queries per job;
the per-job genome window absorbs the band placement instead:
win[rr] = genome[pos + (b-1)/2 - QOFF + rr] (win_start).  Out-of-band
cells read as 0, exactly like the reference's zero-initialized flat table,
and the deletion move skips the last band column (from_above covers
[left, right-1); AbismalAlign.hpp:369-377).

Two implementations of the same recurrence:

- Pallas kernels through Triton (`_score_kernel`, `_trace_kernel`): one
  job per thread, `jb` jobs per program.  The <= BW_MAX band cells of the
  current row are Python-unrolled per-column carries held in registers for
  the whole DP (about lmax + 60 dependent rows, one launch); the deletion
  move reads the neighbouring column's carry, the insertion chain is a
  left-to-right pass over the unrolled columns, and the query window is a
  rotating carry fed by one coalesced row load per step.  Inputs are laid
  out (positions, jobs) so every row load and store is contiguous over the
  program's jobs.
- plain jax.numpy over (BAND, J) arrays (`_plain_scores`, `_plain_trace`):
  lax.fori_loop over rows, lax.dynamic_slice for each row's query window,
  and a log-depth max-prefix scan for the insertion chain.  It is the
  reference the kernels are tested against and the version they are timed
  against (tools/time_banded.py).
"""

from __future__ import annotations

import functools

import numpy as np

ALN_MATCH = 2
ALN_MISMATCH = -3
ALN_INDEL = -4
BW_MAX = 61
BAND = 64  # band columns per traceback panel word group (>= BW_MAX)
QOFF = BW_MAX - 1  # fixed query offset in the transposed query panel
NEG = -(1 << 14)


def _layout(q, win, lp: int):
    """(J, >= lp) query and (J, >= lp + QOFF) window nibbles -> u8
    (positions, J) panels: the query at row offset QOFF with room for the
    last row's BAND-wide window, the genome window from row 0."""
    import jax.numpy as jnp

    n_rows = lp + QOFF
    j = q.shape[0]
    nq = min(lp, q.shape[1])
    qt = jnp.zeros((n_rows + BAND, j), jnp.uint8).at[QOFF : QOFF + nq].set(
        q.T[:nq].astype(jnp.uint8))
    nw = min(n_rows, win.shape[1])
    wt = jnp.zeros((n_rows, j), jnp.uint8).at[:nw].set(
        win.T[:nw].astype(jnp.uint8))
    return qt, wt


def _row(jnp, rr, prev, qw, wb, right, trace: bool):
    """One DP row over the unrolled band columns c < BW_MAX.  prev: the
    previous row's stored cells; qw[c]: query nibble for the diagonal move
    into column c; wb: this row's genome nibble.  Returns the stored cells
    and, when tracing, each cell's packed nibble (see _trace_kernel)."""
    left = jnp.maximum(QOFF - rr, 0)
    stored, nibs = [], []
    lft = jnp.zeros_like(wb)
    for c in range(BW_MAX):
        sub = jnp.where((qw[c] & wb) != 0, ALN_MATCH, ALN_MISMATCH)
        subscore = prev[c] + sub
        c1 = jnp.maximum(subscore, 0)
        c2 = c1
        if c + 1 < BW_MAX:  # c < right - 1 <= BW_MAX - 2 otherwise
            app_d = c < right - 1
            delv = prev[c + 1] + ALN_INDEL
            c2 = jnp.where(app_d, jnp.maximum(c1, delv), c1)
        valid = (c >= left) & (c < right)
        # insertion chain: lft is the stored cell to the left (0 when out
        # of band, and every in-band diagonal/deletion value is >= 0)
        s = jnp.where(valid, jnp.maximum(c2, lft + ALN_INDEL), 0)
        if trace:
            arrow = jnp.where(subscore >= 0, 0, 3)
            if c + 1 < BW_MAX:
                arrow = jnp.where(app_d & (delv >= c1), 2, arrow)
            arrow = jnp.where(s == lft + ALN_INDEL, 1, arrow)
            nibs.append(jnp.where(valid, arrow | jnp.where(s > 0, 4, 0), 0))
        stored.append(s)
        lft = s
    return stored, nibs


def _score_kernel(qt_ref, wt_ref, bw_ref, qsz_ref, out_ref, *, lp: int):
    import jax
    import jax.numpy as jnp

    bw = bw_ref[...]
    qsz = qsz_ref[...]
    zero = jnp.zeros_like(bw)
    qw0 = tuple(qt_ref[c, :].astype(jnp.int32) for c in range(BW_MAX))

    def step(rr, carry):
        prev, qw, best = carry
        right = jnp.minimum(bw, qsz + (QOFF - rr))
        wb = wt_ref[rr, :].astype(jnp.int32)
        stored, _ = _row(jnp, rr, prev, qw, wb, right, False)
        for s in stored:
            best = jnp.maximum(best, s)
        qn = qt_ref[rr + BW_MAX, :].astype(jnp.int32)
        return tuple(stored), qw[1:] + (qn,), best

    _, _, best = jax.lax.fori_loop(
        0, lp + QOFF, step, ((zero,) * BW_MAX, qw0, zero))
    out_ref[...] = best


def _trace_kernel(qt_ref, wt_ref, bw_ref, qsz_ref, nib_ref, best_ref,
                  brr_ref, bc_ref, *, lp: int):
    """Traceback variant of _score_kernel: same recurrence, plus every
    in-band cell's nibble -- bits 0-1 the arrow in the reference's
    equal-score overwrite order M < D < I (M=0, I=1, D=2, none=3), bit 2
    score > 0 -- stored to nib[rr, c] (u8), and the row-major-first argmax
    cell (strict '>' keeps the first maximum in (row asc, col asc) order,
    as build_traceback's scan does).  Out-of-band cells store 0: the walk
    never enters them, and a zero positive-bit stops it exactly like the
    reference's table test."""
    import jax
    import jax.numpy as jnp

    bw = bw_ref[...]
    qsz = qsz_ref[...]
    zero = jnp.zeros_like(bw)
    qw0 = tuple(qt_ref[c, :].astype(jnp.int32) for c in range(BW_MAX))

    def step(rr, carry):
        prev, qw, best, brr, bc = carry
        right = jnp.minimum(bw, qsz + (QOFF - rr))
        wb = wt_ref[rr, :].astype(jnp.int32)
        stored, nibs = _row(jnp, rr, prev, qw, wb, right, True)
        for c, nb in enumerate(nibs):
            nib_ref[rr, c, :] = nb.astype(jnp.uint8)
        rmax, rc = stored[0], zero
        for c in range(1, BW_MAX):
            upd = stored[c] > rmax
            rmax = jnp.where(upd, stored[c], rmax)
            rc = jnp.where(upd, c, rc)
        upd = rmax > best
        best = jnp.where(upd, rmax, best)
        brr = jnp.where(upd, rr, brr)
        bc = jnp.where(upd, rc, bc)
        qn = qt_ref[rr + BW_MAX, :].astype(jnp.int32)
        return tuple(stored), qw[1:] + (qn,), best, brr, bc

    _, _, best, brr, bc = jax.lax.fori_loop(
        0, lp + QOFF, step, ((zero,) * BW_MAX, qw0, zero, zero, zero))
    best_ref[...] = best
    brr_ref[...] = brr
    bc_ref[...] = bc


def _triton_call(kernel, out_shapes, out_blocks, qt, wt, bw, qsz, jb: int,
                 interpret: bool, name: str):
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    j = bw.shape[0]
    assert j % jb == 0, "job count must be a multiple of jb"
    jobs = lambda g: (g,)  # noqa: E731
    return pl.pallas_call(
        kernel,
        grid=(j // jb,),
        in_specs=[pl.BlockSpec((qt.shape[0], jb), lambda g: (0, g)),
                  pl.BlockSpec((wt.shape[0], jb), lambda g: (0, g)),
                  pl.BlockSpec((jb,), jobs),
                  pl.BlockSpec((jb,), jobs)],
        out_specs=out_blocks,
        out_shape=[jax.ShapeDtypeStruct(s, d) for s, d in out_shapes],
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=max(1, jb // 32),
                                            num_stages=1),
        interpret=interpret,
        name=name,
    )(qt, wt, bw, qsz)


def _plain_rows(jnp, jax, qt, wt, bw, qsz, lp: int, carry0, emit):
    """Shared plain-XLA row loop over (BAND, J) arrays: computes each row's
    stored cells (and traceback arrow parts) and hands them to emit."""
    j = bw.shape[0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (BAND, j), 0)
    bw = bw[None, :]
    qsz = qsz[None, :]

    def step(rr, carry):
        prev = carry[0]
        left = jnp.maximum(QOFF - rr, 0)
        right = jnp.minimum(bw, qsz + (QOFF - rr))
        valid = (cols >= left) & (cols < right)
        qrow = jax.lax.dynamic_slice_in_dim(qt, rr, BAND, 0).astype(jnp.int32)
        wb = jax.lax.dynamic_slice_in_dim(wt, rr, 1, 0).astype(jnp.int32)
        sub = jnp.where((qrow & wb) != 0, ALN_MATCH, ALN_MISMATCH)
        subscore = prev + sub
        c1 = jnp.maximum(0, subscore)
        above = jnp.concatenate(
            [prev[1:], jnp.zeros((1, j), jnp.int32)], axis=0)
        delv = above + ALN_INDEL
        app_d = cols < right - 1
        c2 = jnp.where(app_d, jnp.maximum(c1, delv), c1)
        # insertion chain: log-depth max-prefix scan of c2[k] - indel*(c-k)
        m = jnp.where(valid, c2 - ALN_INDEL * cols, NEG)
        shift = 1
        while shift < BAND:
            m = jnp.maximum(m, jnp.concatenate(
                [jnp.full((shift, j), NEG, jnp.int32), m[:-shift]], axis=0))
            shift *= 2
        stored = jnp.where(valid, m + ALN_INDEL * cols, 0)
        parts = dict(subscore=subscore, c1=c1, delv=delv, app_d=app_d,
                     valid=valid, cols=cols)
        return (stored,) + emit(rr, stored, parts, carry[1:])

    return jax.lax.fori_loop(0, lp + QOFF, step, carry0)


def _plain_scores(qt, wt, bw, qsz, lp: int):
    import jax
    import jax.numpy as jnp

    j = bw.shape[0]
    z = jnp.zeros((BAND, j), jnp.int32)

    def emit(rr, stored, parts, carry):
        return (jnp.maximum(carry[0], stored),)

    _, best = _plain_rows(jnp, jax, qt, wt, bw, qsz, lp, (z, z), emit)
    return jnp.max(best, axis=0)


def _plain_trace(qt, wt, bw, qsz, lp: int):
    """Plain-XLA twin of _trace_kernel: same outputs (nib (n_rows, BAND,
    J) u8, best, brr, bc)."""
    import jax
    import jax.numpy as jnp

    j = bw.shape[0]
    n_rows = lp + QOFF
    z = jnp.zeros((BAND, j), jnp.int32)
    z1 = jnp.zeros(j, jnp.int32)

    def emit(rr, stored, p, carry):
        nib, best, brr, bc = carry
        vleft = jnp.concatenate(
            [jnp.zeros((1, j), jnp.int32), stored[:-1]], axis=0)
        arrow = jnp.where(p["subscore"] >= 0, 0, 3)
        arrow = jnp.where(p["app_d"] & (p["delv"] >= p["c1"]), 2, arrow)
        arrow = jnp.where(stored == vleft + ALN_INDEL, 1, arrow)
        nb = jnp.where(p["valid"], arrow | jnp.where(stored > 0, 4, 0), 0)
        nib = jax.lax.dynamic_update_slice_in_dim(
            nib, nb.astype(jnp.uint8)[None], rr, 0)
        rmax = jnp.max(stored, axis=0)
        cstar = jnp.min(jnp.where(stored == rmax[None], p["cols"], BAND),
                        axis=0)
        upd = rmax > best
        return (nib, jnp.where(upd, rmax, best), jnp.where(upd, rr, brr),
                jnp.where(upd, cstar, bc))

    nib0 = jnp.zeros((n_rows, BAND, j), jnp.uint8)
    _, nib, best, brr, bc = _plain_rows(
        jnp, jax, qt, wt, bw, qsz, lp, (z, nib0, z1, z1, z1), emit)
    return nib, best, brr, bc


def _pack_panel(nib, lp: int):
    """(n_rows, >= BW_MAX, J) u8 nibbles -> (n_words*BAND, J) i32 panel:
    word w of band column c holds rows 8w..8w+7 of that column, row
    8w + k in bits 4k..4k+3; jobs fastest (build_tb_block.fetch)."""
    import jax.numpy as jnp

    n_rows = lp + QOFF
    n_words = (n_rows + 7) // 8
    j = nib.shape[-1]
    nib = jnp.pad(nib.astype(jnp.int32),
                  ((0, n_words * 8 - n_rows), (0, BAND - nib.shape[1]),
                   (0, 0))).reshape(n_words, 8, BAND, j)
    word = nib[:, 0]
    for k in range(1, 8):
        word = word | (nib[:, k] << (4 * k))
    return word.reshape(n_words * BAND, j)


def build_banded_tracer(lp: int = 128, jb: int = 128,
                        interpret: bool = False, impl: str = "triton"):
    """Returns a jitted f(q, win, bw, qsz) -> (panel, best, brr, bc):
    panel (n_words*BAND, J) i32 packed traceback nibbles (see
    _trace_kernel and _pack_panel), best/brr/bc (J,) i32 -- the
    row-major-first argmax score and its (reparametrized row rr, band col)
    cell.  Input layout identical to build_banded_scorer."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    n_rows = lp + QOFF
    jobs = lambda g: (g,)  # noqa: E731

    def tracer(q, win, bw, qsz):
        j = q.shape[0]
        qt, wt = _layout(q, win, lp)
        bw = bw.reshape(j).astype(jnp.int32)
        qsz = qsz.reshape(j).astype(jnp.int32)
        if impl == "xla":
            nib, best, brr, bc = _plain_trace(qt, wt, bw, qsz, lp)
        else:
            nib, best, brr, bc = _triton_call(
                functools.partial(_trace_kernel, lp=lp),
                [((n_rows, BW_MAX, j), jnp.uint8), ((j,), jnp.int32),
                 ((j,), jnp.int32), ((j,), jnp.int32)],
                [pl.BlockSpec((n_rows, BW_MAX, jb), lambda g: (0, 0, g)),
                 pl.BlockSpec((jb,), jobs), pl.BlockSpec((jb,), jobs),
                 pl.BlockSpec((jb,), jobs)],
                qt, wt, bw, qsz, jb, interpret, "banded_trace")
        return _pack_panel(nib, lp), best, brr, bc

    return jax.jit(tracer)


def win_start(pos, bw):
    """Genome nibble index of a job's window row 0: the band placement
    t_beg = pos - (bw-1)/2 plus the row reparametrization's ti shift
    (module docstring) collapse to pos + (bw-1)/2 - QOFF."""
    return pos + (bw - 1) // 2 - QOFF


def build_banded_scorer(lp: int = 128, jb: int = 128,
                        interpret: bool = False, impl: str = "triton"):
    """Returns a jitted f(q, win, bw, qsz) -> scores (J, 1) i32.

    q: (J, >= lp) u8 -- query nibbles of job j at column 0 (NOT shifted
        per job; the row reparametrization makes the query placement
        bandwidth-free).
    win: (J, >= lp + QOFF) u8 -- genome nibbles from win_start(pos, bw).
    bw: (J, 1) i32 band widths (<= BW_MAX); qsz: (J, 1) i32 query lengths.

    J must be a multiple of jb.  impl "triton" runs the Pallas kernel,
    "xla" the plain-XLA recurrence."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def scorer(q, win, bw, qsz):
        j = q.shape[0]
        qt, wt = _layout(q, win, lp)
        bw = bw.reshape(j).astype(jnp.int32)
        qsz = qsz.reshape(j).astype(jnp.int32)
        if impl == "xla":
            out = _plain_scores(qt, wt, bw, qsz, lp)
        else:
            (out,) = _triton_call(
                functools.partial(_score_kernel, lp=lp), [((j,), jnp.int32)],
                [pl.BlockSpec((jb,), lambda g: (g,))],
                qt, wt, bw, qsz, jb, interpret, "banded_score")
        return out[:, None]

    return jax.jit(scorer)


def prepare_jobs(genome_nib: np.ndarray, jobs, lp: int = 128, jb: int = 128):
    """Host-side packing: jobs = [(query_nibbles, diffs, max_diffs, t_pos)].
    Returns (q, win, bw, qsz, n_jobs_padded) in the scorer's layout (query
    at column 0, window from win_start(pos, bw))."""
    n = len(jobs)
    j_pad = ((n + jb - 1) // jb) * jb if n else jb
    ww = lp + QOFF
    q_rows = np.zeros((j_pad, lp), dtype=np.uint8)
    win = np.zeros((j_pad, ww), dtype=np.uint8)
    bw = np.ones((j_pad, 1), dtype=np.int32)
    qsz = np.zeros((j_pad, 1), dtype=np.int32)
    for i, (q, diffs, max_diffs, t_pos) in enumerate(jobs):
        b = 2 * min(diffs, max_diffs) + 1
        b = BW_MAX if b < 0 else min(BW_MAX, b)
        length = q.shape[0]
        q_rows[i, :length] = q
        g0 = win_start(t_pos, b)
        w = genome_nib[max(g0, 0) : g0 + ww]
        win[i, max(g0, 0) - g0 : (max(g0, 0) - g0) + w.shape[0]] = w
        bw[i, 0] = b
        qsz[i, 0] = length
    return q_rows, win, bw, qsz, j_pad


def score_jobs(genome_nib: np.ndarray, jobs, lp: int = 128,
               interpret: bool = False, impl: str = "triton"):
    """Convenience wrapper: returns int scores per job.  Jobs with diffs ==
    0 must be short-circuited by the caller, as in the reference."""
    if not jobs:
        return []
    q_rows, win, bw, qsz, _ = prepare_jobs(genome_nib, jobs, lp)
    scorer = build_banded_scorer(lp, interpret=interpret, impl=impl)
    out = np.asarray(scorer(q_rows, win, bw, qsz))
    return [int(out[i, 0]) for i in range(len(jobs))]


def build_device_align(lp: int = 128, jb: int = 128, interpret: bool = False):
    """Device-resident batched scoring for the event-stream path: takes the
    packed genome + the stage-1 unit matrix already on the device plus
    compact job descriptors (unit row, genome pos, band width, query
    length), builds the query rows and genome windows with on-device
    gathers, and runs the banded scorer.  Upload cost is ~20 B/job;
    download 4 B/job.

    Returns a jitted f(genome32, pnib, unit_id, pos, bw, qsz) -> (J,) i32.
    pnib is the stage-1 nibble-packed unit matrix (two query nibbles per
    byte); jobs must be padded to a multiple of jb with qsz=0, bw=1 and an
    in-genome pos (the 32767-N padding guarantees index safety)."""
    import jax
    import jax.numpy as jnp

    scorer = build_banded_scorer(lp, jb, interpret=interpret)
    ww = lp + QOFF

    def prog(genome32, pnib, unit_id, pos, bw, qsz):
        j = unit_id.shape[0]
        rows = pnib[unit_id]
        q = jnp.stack([rows & np.uint8(0xF), rows >> np.uint8(4)],
                      axis=2).reshape(j, -1)
        g0 = (pos + ((bw - 1) // 2).astype(jnp.uint32)
              - np.uint32(QOFF))  # win_start
        gpos = g0[:, None] + jnp.arange(ww, dtype=jnp.uint32)[None, :]
        word = genome32[(gpos >> np.uint32(3)).astype(jnp.int32)]
        win = ((word >> ((gpos & np.uint32(7)) * np.uint32(4)))
               & np.uint32(0xF)).astype(jnp.uint8)
        out = scorer(q, win, bw[:, None], qsz[:, None])
        return out[:, 0]

    return jax.jit(prog)
